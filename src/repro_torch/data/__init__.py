from repro_torch.data.loader import PrefetchLoader
from repro_torch.data.synthetic import (SyntheticCorpus, batch_for,
                                        make_batch_iter, pack_documents)

__all__ = ["PrefetchLoader", "SyntheticCorpus", "batch_for",
           "make_batch_iter", "pack_documents"]
