"""volpick_tpu_torch — volcano-seismicity phase picking in PyTorch on NVIDIA GPUs.

The PyTorch port of ``volpick_tpu`` (JAX on TPU), which stays beside it as
the reference the port is tested against. The port imports neither JAX nor
anything of ``volpick_tpu``; what it needs of that package it keeps as its
own copy.

- ``volpick_tpu_torch.core``   : Stream / Trace / UTC, the pick result types (numpy), SAC,
                                  rotation to ZNE, geodesics, obspy converters
- ``volpick_tpu_torch.io``     : miniSEED and WIN32 (native decoders), StationXML
- ``volpick_tpu_torch.ops``    : framing, stacking, conditioning, trigger extraction
- ``volpick_tpu_torch.ops.cuda``: hand-written Hopper (sm_90a) CUDA kernels, each
                                  with a plain PyTorch twin used on the CPU
- ``volpick_tpu_torch.models`` : EQTransformer, VolEQTransformer, PhaseNet, TPUPickNet eval
                                  forwards, registry, JAX weight conversion
- ``volpick_tpu_torch.picker`` : WaveformPicker (annotate / classify on streams),
                                  StreamingPicker (chunks in, final picks out), the numpy oracle
- ``volpick_tpu_torch.data``   : SeisBench HDF5+CSV datasets (reader, writer), synthetic sets
- ``volpick_tpu_torch.pipeline``: the training augmentations and the batch generator
- ``volpick_tpu_torch.train``  : losses, schedules, EMA, checkpoints, Trainer / train(config),
                                  the native .npz.v1 export
- ``volpick_tpu_torch.eval``   : evaluation targets, the task-0 sweep, tasks 1/2/3
- ``volpick_tpu_torch.classical``: the Baer-Kradolfer and AR-AIC baseline pickers
- ``volpick_tpu_torch.bench``   : the headline benchmark, EQTransformer classify windows/s on the card
- ``python -m volpick_tpu_torch pick|train|targets|evaluate|bench``: the command line
"""

__version__ = "0.1.0"
