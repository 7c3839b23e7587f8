from repro_torch.kernels.moe_gmm import ops, ref
