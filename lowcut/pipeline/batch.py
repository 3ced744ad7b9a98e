"""Pipelined batch execution: host worker threads around the device loop.

The reference's ``-t`` threads power its convolution hot loop
(reference ProcessFile.cp:60-83, main.cp:75). Here the convolution
runs on the device, so the host threads move to where the host still does
real work: container parse + PCM decode (read stage) and PCM encode +
atomic file write (write stage). The batch scenario (main.cp:132-147)
becomes a three-stage pipeline

    reader pool  ->  device filter (main thread, in argument order)  ->  writer pool

so the chip never idles on the filesystem: file k+1 is being read and
file k-1 encoded/written while file k streams through the device.

Semantics preserved from the reference's serial loop:

- files are *filtered* strictly in argument order;
- per-file validation (FileNotFound / FileExists / ``-O`` removal) happens
  at that file's turn in the order, exactly like main.cp:132-147;
- the first error aborts the remaining batch after in-flight writes have
  drained, so files before the error stay written (main.cp:140-147,
  157-160) — with the improvement that outputs are atomic (temp + rename,
  audio/file.py), so an abort never leaves a partial file;
- one kernel-design plan cache is shared across the batch: files with the
  same sample rate reuse the designed kernel and its device spectrum (the
  reference redesigns per file, ProcessFile.cp:48-50 — same result, less
  host work).

A write error surfaces at the next file's turn (or at drain), which can be
slightly *later* than the reference's fail point — the price of overlap;
no additional file is ever written after the error is observed.
"""

from __future__ import annotations

import collections
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

from .. import audio
from ..audio.file import _scale_common
from ..models import make_model
from ..utils.errors import FileExists
from ..utils.options import FilterOptions, resolve_precision
from ..utils.progress import ProgressBar
from .process_file import device_info
from .stream import filter_array_streamed

# Files decoded ahead of the device. Bounded so a batch of hour-long files
# holds at most PREFETCH + 2 decoded buffers in host memory.
PREFETCH = 3


def run_batch(inputs, dest_dir, opts: FilterOptions, *,
              overwrite: bool = False, manifest=None, metrics_cb=None,
              show_progress: bool = True) -> None:
    """Filter ``inputs`` into ``dest_dir`` through the 3-stage pipeline.

    ``metrics_cb(metrics_dict, dest_path)`` is invoked per completed file
    (from a writer thread, serialized by an internal lock). ``manifest`` is
    an optional :class:`.manifest.BatchManifest`; completed files are
    recorded after their write lands and already-done files are skipped.
    """
    inputs = [Path(p) for p in inputs]
    dest_dir = Path(dest_dir)
    workers = opts.resolved_num_threads()

    def show_status(msg: str) -> None:
        if opts.verbose:
            print(msg)

    model = make_model(opts.filter_type, opts.freq, opts.slope,
                       opts.freq_hi)  # shared plan cache across the batch
    read_pool = ThreadPoolExecutor(
        max(1, min(workers, PREFETCH)), thread_name_prefix="lowcut-read")
    write_pool = ThreadPoolExecutor(
        max(1, min(workers, 2)), thread_name_prefix="lowcut-write")
    emit_lock = threading.Lock()
    # dest path -> in-flight write future (duplicate input filenames must
    # serialize against the earlier write before their FileExists check).
    writes: dict[Path, object] = {}

    def write_task(dest_path: Path, data, filtered, input_path: Path,
                   metrics: dict) -> None:
        t0 = time.perf_counter()
        audio.write_audio(dest_path, data, samples=filtered)
        metrics["write"] = time.perf_counter() - t0
        if manifest is not None:
            manifest.mark_done(input_path)
        if metrics_cb is not None:
            with emit_lock:
                metrics_cb(metrics, dest_path)

    def drain(raise_errors: bool) -> None:
        err = None
        for fut in list(writes.values()):
            try:
                fut.result()
            except BaseException as e:  # noqa: BLE001 — collect, re-raise first
                err = err or e
        writes.clear()
        if raise_errors and err is not None:
            raise err

    queue = collections.deque()  # (input_path, read_future | None=skipped)
    next_i = 0

    def pump() -> None:
        nonlocal next_i
        while next_i < len(inputs) and len(queue) < PREFETCH:
            ip = inputs[next_i]
            next_i += 1
            dest = dest_dir / ip.name
            if manifest is not None and manifest.is_done(ip) and dest.exists():
                queue.append((ip, None))
                continue
            # audio.read_audio raises the reference's FileNotFound itself;
            # it surfaces at this file's turn via fut.result().
            queue.append((ip, read_pool.submit(audio.read_audio, ip)))

    try:
        pump()
        while queue:
            ip, fut = queue.popleft()
            pump()  # keep the pipeline full while this file filters

            # Surface any completed write's error before starting more work.
            for d, wf in list(writes.items()):
                if wf.done():
                    wf.result()  # raises on write failure -> abort batch
                    del writes[d]

            if fut is None:
                show_status(f"Skipping (already done): {ip.name}")
                continue

            dest = dest_dir / ip.name
            if dest in writes:  # duplicate filename: wait for earlier write
                writes.pop(dest).result()
            if dest.exists() and not (overwrite or manifest is not None):
                raise FileExists(str(dest))

            metrics = {}
            t0 = time.perf_counter()
            data = fut.result()  # FileNotFound/parse errors surface here
            metrics["read"] = time.perf_counter() - t0  # ~0 when prefetched

            print(f"Processing file: {ip.name}")
            fs = data.fmt.sample_rate
            show_status("Creating sinc kernel for this file's sample rate.")
            t0 = time.perf_counter()
            precision = resolve_precision(opts.precision, data.fmt.encoding)
            plan = model.plan(fs, precision=precision,
                              block_size=opts.block_size, engine=opts.engine)
            metrics["design"] = time.perf_counter() - t0

            show_status("Filtering.")
            total = data.num_frames * data.num_channels
            bar = ProgressBar(total, enabled=show_progress and sys.stdout.isatty())
            t0 = time.perf_counter()
            # Device-fused peak: no host re-scan (ProcessFile.cp:92-97).
            filtered, max_mag = filter_array_streamed(
                data.samples, plan, progress_cb=bar.update)
            metrics["filter"] = time.perf_counter() - t0
            bar.final()

            t0 = time.perf_counter()
            if (max_mag > 1.0 or opts.normalize) and max_mag > 0.0:
                show_status("Doing audio normalize.")
                filtered = _scale_common(filtered, max_mag)
            metrics["normalize"] = time.perf_counter() - t0

            metrics.update(frames=data.num_frames, channels=data.num_channels,
                           sample_rate=fs, peak=max_mag, precision=precision,
                           device=device_info())
            show_status("Writing output file.")
            writes[dest] = write_pool.submit(
                write_task, dest, data, filtered, ip, metrics)

        drain(raise_errors=True)
    except BaseException:
        # Abort remaining batch, but let in-flight writes land (the
        # reference's already-processed files stay written, main.cp:140-147).
        drain(raise_errors=False)
        raise
    finally:
        read_pool.shutdown(wait=False, cancel_futures=True)
        write_pool.shutdown(wait=True)
