"""lowcut — an audio FIR filtering framework in JAX.

A from-scratch reimplementation of the capabilities of the reference tool
``diskerror/audio-fir-filter`` (``lowcut``), with its convolution on an
accelerator (an NVIDIA GPU):

- Host-side WAV/AIFF container + PCM codec with byte-exact metadata
  preservation (reference: c_lib AudioFile/AudioFormat/AudioSamples,
  reconstructed in SURVEY.md §2.2).
- float64 Blackman windowed-sinc kernel design on host
  (reference: c_lib WindowedSinc, /root/reference/ProcessFile.cp:48-50).
- Overlap-save FFT convolution engine on the device (``jnp.fft``, cuFFT
  on the GPU), replacing the
  reference's per-thread direct time-domain loop
  (/root/reference/FilterCore.h:20-79).
- Time-axis sequence parallelism over a `jax.sharding.Mesh` with
  kernel-length halo exchange via `ppermute`
  (reference analog: range-split threading, /root/reference/ProcessFile.cp:60-83).
- CLI-compatible `lowcut` front end (/root/reference/main.cp).
"""

__version__ = "0.1.0"

from .utils.options import FilterOptions  # noqa: F401
from .utils.errors import (  # noqa: F401
    DiskerrorError,
    FileExists,
    FileNotFound,
    StopNoError,
    UsageError,
)
