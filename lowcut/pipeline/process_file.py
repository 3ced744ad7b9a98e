"""Per-file pipeline: read -> design -> filter on device -> normalize -> write.

Device-backed equivalent of the reference's ``process_file``
(/root/reference/ProcessFile.cp:27-120). Stage for stage:

  reference                                   here
  ------------------------------------------  --------------------------------
  AudioFile/AudioFormat/AudioSamples readAll  audio.read_audio (all chunks +
    (ProcessFile.cp:34-41)                      planar float32 samples)
  WindowedSinc(freq/fs, slope/fs).makeLowCut  models.LowCut().taps(fs) ->
    (ProcessFile.cp:48-50)                      overlap-save plan (f64 design)
  per-channel thread fan-out + join           all channels batched into one
    (ProcessFile.cp:57-87)                      device array, time-segmented
                                                streaming (pipeline.stream)
  max_mag reduce + conditional normalize      np peak + single common scale
    (ProcessFile.cp:92-101)
  chunk-copy + writeAll                       audio.write_audio (atomic)
    (ProcessFile.cp:105-117)

Deliberate behavior decisions (SURVEY.md §2.4):
- Auto-normalize when the filtered peak exceeds 1.0 even without ``-n``
  (silent-clipping protection) — preserved exactly (ProcessFile.cp:98-101).
- "Processing file: <name>" prints unconditionally (ProcessFile.cp:37).
- Verbose status lines print iff ``--verbose`` — the reference's main.cp
  inverts this for its own messages (main.cp:69-72, a bug); we follow the
  sane convention of ProcessFile.cp:29-30 everywhere.
"""

from __future__ import annotations

import sys
import time

from .. import audio
from ..audio.file import _scale_common
from ..models import make_model
from ..utils.options import FilterOptions, resolve_precision
from ..utils.progress import ProgressBar
from .stream import filter_array_streamed


def process_file(input_path, output_path, opts: FilterOptions,
                 show_progress: bool = True) -> dict:
    """Filter one audio file. Returns per-stage timing metrics (seconds)."""
    t = {}

    def show_status(msg: str) -> None:
        if opts.verbose:
            print(msg)

    show_status("Opening input file.")
    t0 = time.perf_counter()
    data = audio.read_audio(input_path)
    t["read"] = time.perf_counter() - t0

    name = getattr(input_path, "name", None) or str(input_path).rsplit("/", 1)[-1]
    print(f"Processing file: {name}")

    fs = data.fmt.sample_rate
    show_status("Creating sinc kernel for this file's sample rate.")
    t0 = time.perf_counter()
    model = make_model(opts.filter_type, opts.freq, opts.slope, opts.freq_hi)
    # "auto" picks the f32 engine when the OUTPUT depth can't resolve the
    # difference (<= 16-bit PCM; see utils.options.resolve_precision).
    precision = resolve_precision(opts.precision, data.fmt.encoding)
    if precision != opts.precision:
        show_status(f"Precision 'auto' -> '{precision}' for "
                    f"{data.fmt.encoding.bits}-bit output.")
    plan = model.plan(fs, precision=precision, block_size=opts.block_size,
                      engine=getattr(opts, "engine", "auto"))
    t["design"] = time.perf_counter() - t0

    show_status("Filtering.")
    total = data.num_frames * data.num_channels
    bar = ProgressBar(total, enabled=show_progress and sys.stdout.isatty())
    t0 = time.perf_counter()
    devices = None
    if opts.mesh_shape is not None:
        # Multi-device path: time/channel-sharded segmented convolution
        # (parallel/sharded_conv.py via pipeline/stream.py) — progress
        # advances per segment like the reference bar (ProgressBar.h:34-47).
        from ..parallel import make_mesh
        from .stream import sharded_filter_streamed

        mesh = make_mesh(tuple(opts.mesh_shape))
        devices = list(mesh.devices.flat)
        filtered, max_mag = sharded_filter_streamed(
            data.samples, plan, mesh, progress_cb=bar.update)
    else:
        # Peak comes back from the device, fused into the filter program
        # per segment — no host re-scan of the output (the reference's
        # maxMag loop is ProcessFile.cp:92-97).
        filtered, max_mag = filter_array_streamed(
            data.samples, plan, progress_cb=bar.update)
    t["filter"] = time.perf_counter() - t0
    bar.final()

    # One global common scale, exactly ProcessFile.cp:92-101: normalize if
    # any channel exceeds full scale, or on explicit request. The peak is
    # already known, so the scale is applied in place (no extra max pass).
    t0 = time.perf_counter()
    if (max_mag > 1.0 or opts.normalize) and max_mag > 0.0:
        show_status("Doing audio normalize.")
        filtered = _scale_common(filtered, max_mag)
    t["normalize"] = time.perf_counter() - t0

    show_status("Writing output file.")
    t0 = time.perf_counter()
    audio.write_audio(output_path, data, samples=filtered)
    t["write"] = time.perf_counter() - t0

    show_status("")
    t["frames"] = data.num_frames
    t["channels"] = data.num_channels
    t["sample_rate"] = fs
    t["peak"] = max_mag
    t["precision"] = precision
    t["device"] = device_info(devices)
    return t


def device_info(devices=None) -> dict:
    """Platform, kind and count of the devices that filtered (default: the
    default device) — recorded in the metrics so a run that silently left
    the accelerator shows it."""
    import jax

    devices = devices or jax.devices()[:1]
    d = devices[0]
    return {"platform": d.platform, "kind": d.device_kind,
            "count": len(devices)}
