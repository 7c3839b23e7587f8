from repro_torch.kernels.mlstm_scan import ops, ref
