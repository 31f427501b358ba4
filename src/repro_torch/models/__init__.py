"""Model numerics of the port: the dense decoder family, in PyTorch.

``lm.build_model(cfg)`` assembles embedding, layer stack and tied or
untied head from `common`, `attention` and `transformer`; full-sequence
attention goes through the hand-written CUDA flash-attention kernel
(`repro_torch.kernels.flash_attention`) when ``attention_impl == "pallas"``.
"""
