"""volpick_tpu_torch — volcano-seismicity phase picking in PyTorch on NVIDIA GPUs.

The PyTorch port of ``volpick_tpu`` (JAX on TPU), which stays beside it as
the reference the port is tested against. The port imports no JAX; it shares
only the JAX-free host layer ``volpick_tpu.core`` (Stream/Trace, picks).

- ``volpick_tpu_torch.ops``    : framing, stacking, conditioning, trigger extraction
- ``volpick_tpu_torch.ops.cuda``: hand-written Hopper (sm_90a) CUDA kernels, each
                                  with a plain PyTorch twin used on the CPU
- ``volpick_tpu_torch.models`` : EQTransformer eval forward, registry, JAX weight conversion
- ``volpick_tpu_torch.picker`` : WaveformPicker (annotate / classify on streams)
"""

__version__ = "0.1.0"
