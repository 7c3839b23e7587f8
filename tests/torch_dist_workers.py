"""Worker processes for the port's gloo tests (``test_torch_compression``):
each joins a gloo group through a file store and writes what it saw to
``out_dir/rank{r}.pt``.  Imports torch and the port only, so that a
spawned worker starts quickly."""
import os

import numpy as np
import torch
import torch.distributed as dist


def _join(rank, world, init_file):
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            world_size=world, rank=rank)


def all_reduce_worker(rank, world, init_file, out_dir):
    """Seeded gradients and errors of rank ``rank`` through
    ``all_reduce_int8_with_ef``."""
    from repro_torch.optim.compression import all_reduce_int8_with_ef
    _join(rank, world, init_file)
    try:
        rng = np.random.default_rng(100 + rank)
        grads = {"a": torch.as_tensor(rng.standard_normal((7, 5)) * (rank + 1),
                                      dtype=torch.float32),
                 "b": [torch.as_tensor(rng.standard_normal(33) * 1e-3,
                                       dtype=torch.float32)]}
        errors = {"a": torch.as_tensor(rng.standard_normal((7, 5)) * 1e-2,
                                       dtype=torch.float32),
                  "b": [torch.zeros(33)]}
        mean, new = all_reduce_int8_with_ef(grads, errors)
        torch.save({"grads": grads, "errors": errors, "mean": mean,
                    "new": new}, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def compressed_step_worker(rank, world, init_file, out_dir):
    """One step of ``make_train_step_dp_compressed`` of reduced minicpm-2b
    on this rank's half of a seeded batch; records the gradients that went
    into the all-reduce and what came out, the metrics and the
    parameters after the step."""
    from repro_torch.configs import get_arch
    from repro_torch.data import batch_for
    from repro_torch.launch import steps
    from repro_torch.models import registry as R
    from repro_torch.models.config import ShapeSpec
    from repro_torch.optim import AdamWConfig, adamw_init, compression
    from repro_torch.tree import tree_leaves
    _join(rank, world, init_file)
    seen = {}
    reduce = compression.all_reduce_int8_with_ef

    def recording(grads, errors, group=None):
        seen["grads"] = [g.clone() for g in tree_leaves(grads)]
        seen["errors"] = [e.clone() for e in tree_leaves(errors)]
        used, new = reduce(grads, errors, group)
        seen["used"] = [u.clone() for u in tree_leaves(used)]
        seen["new"] = [n.clone() for n in tree_leaves(new)]
        return used, new
    compression.all_reduce_int8_with_ef = recording
    try:
        cfg = get_arch("minicpm-2b").reduced()
        params = R.init_params(cfg, 0, device="cpu",
                               param_dtype=torch.float32)
        opt = adamw_init(params)
        errors = steps.init_ef_errors(params)
        batch = batch_for(cfg, ShapeSpec("t", 32, 4, "train"), seed=0)
        step = steps.make_train_step_dp_compressed(
            cfg, AdamWConfig(lr=1e-3, warmup_steps=1), device="cpu")
        params, opt, errors, metrics = step(params, opt, errors, batch)
        torch.save({"seen": seen,
                    "metrics": {k: float(v) for k, v in metrics.items()},
                    "params": [p.detach().clone()
                               for p in tree_leaves(params)]},
                   os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        compression.all_reduce_int8_with_ef = reduce
        dist.destroy_process_group()
