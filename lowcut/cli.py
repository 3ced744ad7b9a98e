"""``lowcut`` command-line interface.

Replicates the argument surface and scenario/validation matrix of the
reference binary (/root/reference/main.cp) — same flags, same defaults,
same exit codes — plus extensions (precision/engine/block-size/mesh, JSON
metrics).

Scenarios (main.cp:26-31, HELP_TEXT):
  lowcut [options] <input_file> <output_file>
  lowcut [options] <input_file1> [input_file2 ...] <output_directory>

Validation matrix preserved exactly (SURVEY.md §2.4):
- 2 paths: input must exist (FileNotFound); output must not be a directory
  (UsageError); extensions must match (UsageError); existing output without
  -O aborts (FileExists); with -O it is removed first (main.cp:84-107).
- >2 paths: last is the destination dir; created if missing, but a missing
  destination *with an extension* is an error (main.cp:114-130); outputs
  keep the input filename; per-file overwrite rules as above; an error
  aborts the remaining batch (files already written stay written).
- Exit codes: 0 for --help (StopNoError), 1 for any error (main.cp:150-166).

Deliberate fix (SURVEY.md §2.4): status lines like "Using N threads." print
iff --verbose; the reference inverts this in main.cp:69-72 (bug).
"""

from __future__ import annotations

import argparse
import os
import sys
from pathlib import Path

from .utils.errors import DiskerrorError, FileExists, FileNotFound, StopNoError, UsageError
from .utils.options import ENGINES, FilterOptions

HELP_TEXT = """\
Applies low-cut (high-pass) FIR filter to WAVE or AIFF file.
Usage:
  lowcut [options] <input_file> <output_file>
  lowcut [options] <input_file1> [input_file2 ...] <output_directory>
"""


class _Parser(argparse.ArgumentParser):
    """argparse that raises UsageError (exit 1) instead of exiting with 2."""

    def error(self, message):
        raise UsageError(message)


def build_parser() -> argparse.ArgumentParser:
    p = _Parser(
        prog="lowcut",
        description=HELP_TEXT,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    # Reference-compatible options (main.cp:43-59).
    p.add_argument("-f", "--frequency", type=float, default=15.0, metavar="Hz",
                   help="Filter cutoff frequency in Hz. (default: 15)")
    p.add_argument("-s", "--slope", type=float, default=10.0, metavar="Hz",
                   help="Filter slope width in Hz. (default: 10)")
    p.add_argument("-n", "--normalize", action="store_true",
                   help="Normalize output to maximum level.")
    p.add_argument("-v", "--verbose", action="store_true",
                   help="Verbose output.")
    p.add_argument("-t", "--threads", type=int, default=0, metavar="N",
                   help="Number of host worker threads "
                        "(default is 2/3 of the processors available).")
    p.add_argument("-O", "--overwrite", action="store_true",
                   help="Overwrite existing files.")
    # Extensions beyond the reference.
    p.add_argument("--filter", dest="filter_type", default="lowcut",
                   choices=["lowcut", "highpass", "lowpass", "bandpass",
                            "bandreject"],
                   help="Filter family (windowed-sinc). 'lowcut' is the "
                        "reference behavior; band filters take -f as the "
                        "low edge and --frequency-high as the high edge. "
                        "(default: lowcut)")
    p.add_argument("-F", "--frequency-high", type=float, default=None,
                   metavar="Hz",
                   help="Band high edge in Hz (bandpass/bandreject only).")
    p.add_argument("--precision", choices=["auto", "high", "fast"],
                   default="auto",
                   help="Convolution precision: 'high' = float64 FFT "
                        "(matches float64 reference within 1 LSB @ 24-bit), "
                        "'fast' = float32 FFT (within 1 LSB @ 16-bit), "
                        "'auto' = 'fast' for <= 16-bit PCM outputs, 'high' "
                        "otherwise. (default: auto)")
    p.add_argument("--block-size", type=int, default=0, metavar="B",
                   help="Overlap-save FFT size (power of two; 0 = auto).")
    p.add_argument("--engine", choices=["auto", *ENGINES], default="auto",
                   help="FFT engine: 'fft' (jnp.fft, cuFFT on the GPU; "
                        "float64 for high precision), or the framework's "
                        "own FFTs in plain JAX, double-float for high "
                        "precision: 'fourstep' (2-D constant geometry), "
                        "'pease' (1-D constant geometry), 'stockham' "
                        "(unrolled; slow to compile). 'auto' = fft. "
                        "(default: auto)")
    p.add_argument("--mesh", type=str, default=None, metavar="DxT",
                   help="Device mesh shape data x time, e.g. 1x8: shard the "
                        "sample axis across T devices (halo exchange) and "
                        "channels across D devices. Default: single device.")
    # Multi-host launch (SURVEY.md §5: jax.distributed runtime; one process
    # per host, batch files sharded across processes on the data axis).
    p.add_argument("--coordinator", metavar="HOST:PORT", default=None,
                   help="Multi-host: coordinator address for "
                        "jax.distributed.initialize (process 0's host).")
    p.add_argument("--num-processes", type=int, default=None, metavar="N",
                   help="Multi-host: total number of JAX processes.")
    p.add_argument("--process-id", type=int, default=None, metavar="I",
                   help="Multi-host: this process's index (0-based).")
    p.add_argument("--profile", metavar="DIR", default=None,
                   help="Write a jax.profiler trace of the run to DIR "
                        "(inspect with TensorBoard / xprof; SURVEY.md §5 "
                        "observability).")
    p.add_argument("--json-metrics", action="store_true",
                   help="Print per-stage timing metrics as JSON to stderr.")
    p.add_argument("--resume", action="store_true",
                   help="Batch mode: keep a manifest in the destination "
                        "directory and skip files already completed by a "
                        "previous (possibly failed) run with the same "
                        "filter settings.")
    p.add_argument("paths", nargs="*", help=argparse.SUPPRESS)
    return p


def _parse_mesh(spec: str | None):
    if spec is None:
        return None
    try:
        d, t = spec.lower().split("x")
        shape = (int(d), int(t))
        if shape[0] < 1 or shape[1] < 1:
            raise ValueError
        return shape
    except ValueError:
        raise UsageError(f"--mesh expects DxT (e.g. 1x8), got {spec!r}") from None


def _options_from_args(args) -> FilterOptions:
    return FilterOptions(
        freq=args.frequency,
        slope=args.slope,
        filter_type=args.filter_type,
        freq_hi=args.frequency_high,
        normalize=args.normalize,
        verbose=args.verbose,
        num_threads=args.threads,
        precision=args.precision,
        engine=args.engine,
        block_size=args.block_size,
        mesh_shape=_parse_mesh(args.mesh),
        json_metrics=args.json_metrics,
    )


def _emit_metrics(metrics: dict, path, args) -> None:
    if args.json_metrics:
        import json

        payload = {"file": str(path), **{k: v for k, v in metrics.items()}}
        fr, fs = metrics.get("frames", 0), metrics.get("filter", 0.0)
        if fs > 0:
            payload["samples_per_sec"] = fr * metrics.get("channels", 1) / fs
        print(json.dumps(payload), file=sys.stderr)


def run(argv=None) -> None:
    """Scenario logic (raises typed exceptions; `main` maps to exit codes)."""
    args = build_parser().parse_args(argv)

    # Band-filter option sanity, before any JAX import is paid.
    if args.filter_type in ("bandpass", "bandreject"):
        if args.frequency_high is None:
            raise UsageError(
                f"--filter {args.filter_type} requires --frequency-high.")
        if args.frequency_high <= args.frequency:
            raise UsageError(
                "--frequency-high must exceed --frequency "
                f"({args.frequency_high} <= {args.frequency}).")
    elif args.frequency_high is not None:
        raise UsageError(
            "--frequency-high only applies to --filter bandpass/bandreject.")

    opts = _options_from_args(args)

    def show_status(msg: str) -> None:
        if opts.verbose:
            print(msg)

    show_status(f"Using {opts.resolved_num_threads()} threads.")

    # Import the pipeline lazily: --help and usage errors must not pay (or
    # require) JAX/device initialization.
    from .pipeline import process_file

    if (args.coordinator is not None or args.num_processes is not None
            or args.process_id is not None):
        # Multi-host launch: join the jax.distributed runtime before any
        # device work (parallel/distributed.py).
        from .parallel.distributed import initialize

        initialize(args.coordinator, args.num_processes, args.process_id)
        from .parallel.distributed import process_info

        pi, pc = process_info()
        show_status(f"Joined distributed runtime: process {pi}/{pc}.")

    if args.profile:
        # jax.profiler trace of the whole run (device ops + host timeline).
        import atexit

        import jax.profiler

        jax.profiler.start_trace(args.profile)
        atexit.register(jax.profiler.stop_trace)
        show_status(f"Profiling to {args.profile} (jax.profiler trace).")

    paths = [Path(s) for s in args.paths]

    if len(paths) == 2:
        # Scenario 1: input file -> output file (main.cp:84-109)
        input_path, output_path = paths
        if not input_path.is_file():
            raise FileNotFound(str(input_path))
        if output_path.exists() and output_path.is_dir():
            raise UsageError(
                "With two parameters the second parameter must be a file path, "
                "not a directory.")
        if input_path.suffix != output_path.suffix:
            raise UsageError(
                "Input and output file types (WAVE or AIFF) must be the same "
                "(extensions must match).")
        if output_path.exists() and not args.overwrite:
            raise FileExists(str(output_path))
        if output_path.exists():
            os.remove(output_path)
        metrics = process_file(input_path, output_path, opts)
        _emit_metrics(metrics, output_path, args)

    elif len(paths) > 2:
        # Scenario 2: input files -> output directory (main.cp:112-147)
        dest_dir = paths[-1]
        if dest_dir.exists():
            if not dest_dir.is_dir():
                raise UsageError(
                    f"Destination exists but is not a directory: {dest_dir}")
        else:
            if dest_dir.suffix:
                raise UsageError(
                    f"Destination directory '{dest_dir}' does not exist and "
                    f"has a suffix. Undefined scenario.")
            show_status(f"Creating directory: {dest_dir}")
            dest_dir.mkdir(parents=True)

        manifest = None
        if args.resume:
            from .pipeline.manifest import BatchManifest, options_fingerprint

            manifest = BatchManifest(dest_dir, options_fingerprint(opts))

        inputs = paths[:-1]
        # Multi-host batch: shard files across JAX processes (each host
        # filters its own subset; no cross-host traffic).
        try:
            import jax

            if jax.process_count() > 1:
                from .parallel.distributed import shard_files

                inputs = shard_files(inputs)
        except Exception:
            pass

        if opts.mesh_shape is None:
            # Pipelined batch: host reader/writer worker threads (the -t
            # pool) overlap file I/O with the device loop (pipeline/batch.py).
            from .pipeline.batch import run_batch

            run_batch(
                inputs, dest_dir, opts,
                overwrite=args.overwrite, manifest=manifest,
                metrics_cb=(lambda m, d: _emit_metrics(m, d, args))
                if args.json_metrics else None)
        else:
            # Sharded multi-device filtering keeps the serial per-file loop
            # (the mesh owns the parallelism; no point pipelining around it).
            for input_path in inputs:
                if not input_path.is_file():
                    raise FileNotFound(str(input_path))
                dest_path = dest_dir / input_path.name
                if manifest is not None and manifest.is_done(input_path) \
                        and dest_path.exists():
                    show_status(f"Skipping (already done): {input_path.name}")
                    continue
                if dest_path.exists() and not (args.overwrite or args.resume):
                    raise FileExists(str(dest_path))
                if dest_path.exists():
                    os.remove(dest_path)
                metrics = process_file(input_path, dest_path, opts)
                _emit_metrics(metrics, dest_path, args)
                if manifest is not None:
                    manifest.mark_done(input_path)

    else:
        raise UsageError("Invalid number of parameters. Need at least 2.")


def main(argv=None) -> int:
    """Entry point with the reference's exception-to-exit-code mapping
    (main.cp:150-166)."""
    try:
        run(argv)
    except StopNoError as e:
        msg = str(e)
        if msg:
            print(msg)
        return 0
    except SystemExit as e:  # argparse --help exits 0
        return int(e.code or 0)
    except DiskerrorError as e:
        print(e, file=sys.stderr)
        return 1
    except Exception as e:  # noqa: BLE001 — reference catches everything
        print(e, file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
