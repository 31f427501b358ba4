"""Hand-written CUDA kernels of the port (built at first use).

* `repro_torch.kernels.timing_scan` -- the schedule-IR timing recurrence
  (``csrc/timing_scan.cu``), with its plain torch version and launch count.
* `repro_torch.kernels.flash_attention` -- blocked online-softmax
  attention (``csrc/flash_attention.cu``), with its plain torch version,
  launch count and the model-layout wrapper.
* `repro_torch.kernels.ssd_scan` -- the Mamba2 SSD chunked scan
  (``csrc/ssd_scan.cu``), with its plain torch version, launch count and
  the model-layout wrapper.
* `repro_torch.kernels.rmsnorm` -- row RMSNorm (``csrc/rmsnorm.cu``), with
  its plain torch version, launch count and the (..., D) wrapper that the
  models' ``rms_norm`` calls.
* `repro_torch.kernels.fused_reduce` -- elementwise a + b in float32, the
  reduce-scatter local combine (``csrc/fused_reduce.cu``), with its plain
  torch version and launch count.
* `repro_torch.kernels.ops` -- the four public wrappers in the models'
  layouts, as the reference's ``kernels/ops.py`` (no ``interpret``
  argument: the tensors' device picks the kernel or its plain version).

`repro_torch.benchmarks.kernel_bench` times each kernel at the reference
bench's shapes (``python -m repro_torch.benchmarks.kernel_bench
[--device cpu]``).
"""
