from repro_torch.kernels.flash_attention import ops, ref
