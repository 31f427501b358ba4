"""Model numerics of the port: decoder, Mamba2 and Zamba2 families.

``lm.build_model(cfg)`` assembles embedding, layer stack and tied or
untied head from `common`, `attention`, `transformer` and `ssm`;
full-sequence attention goes through the hand-written CUDA
flash-attention kernel (`repro_torch.kernels.flash_attention`) when
``attention_impl == "pallas"``, and every Mamba2 layer's chunked scan
through the hand-written CUDA SSD kernel (`repro_torch.kernels.ssd_scan`).
"""
