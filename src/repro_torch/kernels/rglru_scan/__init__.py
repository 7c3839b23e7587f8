from repro_torch.kernels.rglru_scan import ops, ref
