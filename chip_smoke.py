#!/usr/bin/env python
"""Smoke test of lowcut on an NVIDIA GPU, through the tool's own entry points.

    python chip_smoke.py          # one card, every phase below
    python chip_smoke.py --four   # four cards: --mesh 1x4 against one card

Phases on one card:

1. device   the default JAX device must be a GPU; prints the card's name
            and power limit (nvidia-smi), its JAX kind and the count.
2. tests    the tests marked ``gpu`` (pytest in this process).
3. engines  fft and fourstep at both precisions on the headline kernel
            (96 kHz, -f 15 -s 10: M = 38,400, B = 2^18): compile time,
            memory_analysis(), the float64-oracle gate (<= 1 LSB @ 24-bit
            high, <= 1 LSB @ 16-bit fast, scale-relative) on seeded noise
            over several blocks with both edges and a ragged tail, and the
            time of one streaming segment, the four in turns.
4. cli      ``lowcut.cli.main --json-metrics`` on seeded synthetic files:
            (a) 1 h of 96 kHz stereo 24-bit WAV at the defaults (auto ->
            high), (b) 44.1 kHz 16-bit WAV (auto -> fast), (c) AIFF with
            -n. Each must exit 0, keep its non-audio chunks byte-exact,
            match the oracle within the gate on windows at both edges,
            across a streaming-segment seam and in the interior, and name
            the GPU that filtered it in its metrics.
5. more-engines  the same gate for the remaining --engine choices (pease,
            stockham), last because they are the slowest to compile.

``--four`` runs only the mesh phase: ``--mesh 1x4`` on the headline file at
both precisions, against the one-card filter of the same samples and the
oracle at the shard seams, and checks that all four cards held shards.

The last line of stdout is ``{"ok": true, "device": {...}}`` when every
phase passed. Otherwise, and without a GPU, the script exits non-zero and
prints no such line. Synthetic files live in a temporary directory inside
the checkout and are removed at exit.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import shutil
import subprocess
import sys
import tempfile
import time
import traceback
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

# Headline kernel: 96 kHz, the CLI defaults -f 15 -s 10 -> M = 38,400.
FS, FREQ, SLOPE = 96000.0, 15.0, 10.0
GATE_BLOCK = 1 << 18
TIMED_ROUNDS = 3
WINDOW = 8192


class Failed(Exception):
    pass


def log(*a) -> None:
    print(*a, flush=True)


def check(cond, msg: str) -> None:
    if not cond:
        raise Failed(msg)


# --------------------------------------------------------------- phases

def phase_device(cards: int) -> dict:
    import jax

    devs = jax.devices()
    d = devs[0]
    info = {"platform": d.platform, "kind": d.device_kind,
            "count": len(devs)}
    if d.platform != "gpu":
        raise Failed(f"no GPU: JAX's default device is {d.platform} "
                     f"({d.device_kind})")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    for line in smi.stdout.strip().splitlines():
        log(line.strip())  # name, power limit: as nvidia-smi gives them
    log(f"jax: {jax.__version__}, {d.platform} {d.device_kind} "
        f"x{len(devs)}")
    check(len(devs) >= cards, f"needs {cards} devices, has {len(devs)}")
    from lowcut.audio.codec import codec_name

    log(f"pcm codec: {codec_name()}")
    return info


def phase_tests() -> None:
    import os

    import pytest

    env = dict(os.environ)
    try:
        rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                          "--rootdir", str(ROOT), str(ROOT / "tests")])
    finally:
        os.environ.clear()
        os.environ.update(env)
    check(rc == 0, f"pytest -m gpu exited {rc}")


def _headline_taps(sizes):
    from lowcut.ops import kernel_design as kd

    return kd.WindowedSinc(sizes.freq / sizes.fs,
                           sizes.slope / sizes.fs).make_low_cut().taps


def _compile_segment(plan, seg):
    """The streaming pipeline's segment program for ``plan``, compiled
    ahead of time: returns (run(xe) -> (y, peak), compile seconds)."""
    import jax
    import jax.numpy as jnp

    from lowcut.ops import overlap_save as osv

    shape = jax.ShapeDtypeStruct((2, seg + plan.m), jnp.float32)
    t0 = time.perf_counter()
    with osv.x64_scope(plan.static):
        compiled = osv._extended_filter_peak_jit.lower(
            shape, plan.static, plan.H, seg).compile()
    dt = time.perf_counter() - t0
    mem = compiled.memory_analysis()
    if mem is not None:
        log(f"  memory_analysis: argument {mem.argument_size_in_bytes}, "
            f"output {mem.output_size_in_bytes}, temp "
            f"{mem.temp_size_in_bytes}, generated code "
            f"{mem.generated_code_size_in_bytes} bytes")

    def run(xe):
        with osv.x64_scope(plan.static):
            return compiled(xe, plan.H)

    return run, dt


def _gate(run, plan, seg, taps, precision) -> float:
    """Oracle gate through the segment program: noise of a ragged length
    n (several blocks) sits after a zero left halo and is followed by
    zeros, so out[:n] is the zero-padded 'same' filter of the noise."""
    import jax.numpy as jnp

    from lowcut.ops import oracle

    bits = 24 if precision == "high" else 16
    n = min(seg, 3 * plan.hop + plan.hop // 3)
    rng = np.random.default_rng(7)
    worst = 0.0
    for amp in (1.0, 2.4):  # full scale, and an output peak in [2, 4)
        x = rng.uniform(-amp, amp, (2, n)).astype(np.float32)
        xe = np.zeros((2, seg + plan.m), np.float32)
        xe[:, plan.mo2 : plan.mo2 + n] = x
        y, _ = run(jnp.asarray(xe))
        y = np.asarray(y)[:, :n]
        check(y.dtype == np.float32 and np.isfinite(y).all(),
              "non-finite or non-float32 output")
        for c in range(2):
            want = oracle.fft_filter_f64(x[c], taps)
            worst = max(worst, oracle.max_scaled_lsb_error(y[c], want, bits))
    return worst


def phase_engines(sizes, engines, timed_rounds) -> None:
    import jax.numpy as jnp

    from lowcut.ops import overlap_save as osv

    taps = _headline_taps(sizes)
    log(f"headline kernel: {len(taps)} taps (M = {len(taps) - 1}), "
        f"B = {sizes.block}; default engine: {osv.default_engine()}")
    timed = {}
    failures = []
    xe = None
    for engine in engines:
        for precision in ("high", "fast"):
            name = f"{engine}/{precision}"
            plan = osv.make_plan(taps, precision, sizes.block, engine)
            seg = sizes.segment(plan)
            log(f"{name}: segment 2 x {seg} frames (+{plan.m} halo)")
            run, t_compile = _compile_segment(plan, seg)
            err = _gate(run, plan, seg, taps, precision)
            bits = 24 if precision == "high" else 16
            ok = err <= 1.0
            if xe is None or xe.shape[1] != seg + plan.m:
                xe = jnp.asarray(0.3 * np.sin(0.37 * np.arange(
                    seg + plan.m, dtype=np.float32))[None].repeat(2, 0))
            t0 = time.perf_counter()
            run(xe)[0].block_until_ready()
            t_run = time.perf_counter() - t0
            log(f"{name}: compile {t_compile:.2f} s; gate {err:.4f} "
                f"scale-relative LSB @ {bits}-bit -> "
                f"{'PASS' if ok else 'FAIL'}; one segment {t_run:.4f} s "
                f"({2 * seg / t_run / 1e6:.1f} Msamples/s)")
            if not ok:
                failures.append(name)
            if timed_rounds:
                timed[name] = (run, seg, [])
    # The engines in turns, on one device-resident segment each.
    for _ in range(timed_rounds):
        for name, (run, seg, times) in timed.items():
            t0 = time.perf_counter()
            run(xe)[0].block_until_ready()
            times.append(time.perf_counter() - t0)
    for name, (_, seg, times) in timed.items():
        med = float(np.median(times))
        log(f"timed {name}: median {med:.4f} s per segment over "
            f"{len(times)} turns ({2 * seg / med / 1e6:.1f} Msamples/s); "
            f"all {['%.4f' % t for t in times]}")
    check(not failures, f"engines failed their gate: {failures}")


def _cli(argv) -> tuple[int, list[dict], float]:
    """Run ``lowcut.cli.main(argv)``; returns (rc, metrics lines, wall)."""
    from lowcut.cli import main

    err = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stderr(err):
        rc = main(argv)
    wall = time.perf_counter() - t0
    metrics = []
    for line in err.getvalue().splitlines():
        if line.startswith("{"):
            metrics.append(json.loads(line))
        elif line.strip():
            log(f"  stderr: {line}")
    return rc, metrics, wall


def _synth(path, fs, seconds, encoding, extra, seed=0, amp=0.5):
    """Seeded stereo noise written as ``path``; returns nothing (the check
    reads the file back, as the tool does)."""
    from lowcut.audio.synth import create_audio_file

    n = int(seconds * fs)
    rng = np.random.default_rng(seed)
    x = np.empty((2, n), np.float32)
    for s0 in range(0, n, 1 << 24):
        s1 = min(n, s0 + (1 << 24))
        x[:, s0:s1] = rng.uniform(-amp, amp, (2, s1 - s0))
    t0 = time.perf_counter()
    create_audio_file(path, x, fs, encoding=encoding, extra_chunks=extra)
    log(f"  synthesized {path.name}: 2 x {n} frames in "
        f"{time.perf_counter() - t0:.1f} s")


def _windows(n, seams):
    w = min(WINDOW, n)
    spans = [(0, w), (n - w, n), (n // 2, min(n, n // 2 + w))]
    spans += [(s - w // 2, s + w // 2) for s in seams
              if w // 2 <= s <= n - w // 2]
    return spans


def _check_windows(x_in, y_out, taps, spans, scale, bits, label) -> float:
    from lowcut.ops import oracle

    worst = 0.0
    for c in range(x_in.shape[0]):
        for a, b in spans:
            want = oracle.window_filter_f64(x_in[c], taps, a, b) * scale
            worst = max(worst, oracle.max_lsb_error(y_out[c, a:b], want,
                                                    bits))
    log(f"  {label}: oracle windows {spans} -> max {worst:.4f} LSB @ "
        f"{bits}-bit")
    check(worst <= 1.0, f"{label}: {worst:.4f} LSB @ {bits}-bit > 1.0")
    return worst


def phase_cli(sizes, work: Path, device: dict) -> None:
    from lowcut import audio
    from lowcut.audio import Encoding
    from lowcut.audio.chunks import Chunk
    from lowcut.models import make_model
    from lowcut.pipeline.stream import default_segment_len

    extra = [Chunk(b"bext", b"lowcut smoke metadata\x00\x01\x02"),
             Chunk(b"JUNK", b"odd")]
    aiff_extra = [Chunk(b"ANNO", b"lowcut smoke annotation"),
                  Chunk(b"NAME", b"odd")]
    runs = [
        ("a", "headline.wav", sizes.fs, sizes.headline_s, Encoding.PCM_24,
         extra, sizes.freq, [], "high"),
        ("b", "cd.wav", sizes.fs_cd, sizes.other_s, Encoding.PCM_16,
         extra, sizes.freq, [], "fast"),
        ("c", "cfg3.aif", sizes.fs_cd, sizes.other_s, Encoding.PCM_24,
         aiff_extra, sizes.freq_c, ["-n"], "high"),
    ]
    for label, fname, fs, seconds, enc, chunks, freq, flags, want_prec \
            in runs:
        flags = flags + sizes.cli_flags(freq)
        log(f"cli ({label}): {fname}, {fs:g} Hz, {seconds:g} s, "
            f"{enc.bits}-bit, flags {flags}")
        inp, out = work / fname, work / f"out_{fname}"
        _synth(inp, fs, seconds, enc, chunks, seed=ord(label))
        argv = [str(inp), str(out), "-O", "--json-metrics", *flags]
        rc, metrics, wall = _cli(argv)
        check(rc == 0, f"cli ({label}) exited {rc}")
        check(len(metrics) == 1, f"cli ({label}): {len(metrics)} metric lines")
        m = metrics[0]
        log(f"  rc 0 in {wall:.1f} s; metrics " + json.dumps(
            {k: (round(v, 4) if isinstance(v, float) else v)
             for k, v in m.items()}))
        md = m.get("device") or {}
        check((md.get("platform"), md.get("kind"))
              == (device["platform"], device["kind"]),
              f"cli ({label}) filtered on {md}, not {device}")
        check(m.get("precision") == want_prec,
              f"cli ({label}) precision {m.get('precision')} != {want_prec}")

        din, dout = audio.read_audio(inp), audio.read_audio(out)
        cin = [(c.ckid, c.data) for c in din.container.chunks
               if c.ckid not in (b"data", b"SSND")]
        cout = [(c.ckid, c.data) for c in dout.container.chunks
                if c.ckid not in (b"data", b"SSND")]
        check(cin == cout and all((c.ckid, c.data) in cin for c in chunks),
              f"cli ({label}): non-audio chunks changed")
        check(dout.samples.shape == din.samples.shape
              and dout.fmt.encoding == din.fmt.encoding,
              f"cli ({label}): output shape/encoding differs")
        log(f"  {len(cin)} non-audio chunks byte-exact")

        model = make_model("lowcut", freq, sizes.slope, None)
        plan = model.plan(fs, precision=want_prec, block_size=sizes.cli_block)
        taps = model.taps(fs)
        seg = default_segment_len(plan, channels=2)
        n = din.num_frames
        seams = [seg] if n > seg else []
        check(seams or sizes.rehearsal,
              f"cli ({label}): {n} frames never cross a segment ({seg})")
        peak = float(m["peak"])
        scale = 1.0 / peak if ("-n" in flags or peak > 1.0) else 1.0
        _check_windows(din.samples, dout.samples, taps, _windows(n, seams),
                       scale, enc.bits, f"cli ({label})")
        del din, dout
        inp.unlink()
        out.unlink()


def phase_four(sizes, work: Path) -> None:
    from lowcut import audio
    from lowcut.audio import Encoding
    from lowcut.models import make_model
    from lowcut.parallel import make_mesh, sharded_filter
    from lowcut.pipeline.stream import (filter_array_streamed,
                                        sharded_segment_len)

    inp = work / "headline.wav"
    _synth(inp, sizes.fs, sizes.headline_s, Encoding.PCM_24, [], seed=4)
    din = audio.read_audio(inp)
    n = din.num_frames
    model = make_model("lowcut", sizes.freq, sizes.slope, None)
    taps = model.taps(sizes.fs)

    mesh = make_mesh((1, 4))
    plan = model.plan(sizes.fs, precision="fast", block_size=sizes.cli_block)
    y, _ = sharded_filter(din.samples[:, : 4 * plan.hop * 2], plan, mesh)
    held = {s.device for s in y.addressable_shards}
    log(f"four: shards of one segment on {sorted(d.id for d in held)}")
    check(len(held) == 4, f"shards on {len(held)} devices, not 4")

    for precision, bits in (("high", 24), ("fast", 16)):
        plan = model.plan(sizes.fs, precision=precision,
                          block_size=sizes.cli_block)
        out = work / f"out4_{precision}.wav"
        rc, metrics, wall = _cli([str(inp), str(out), "-O", "--json-metrics",
                                  "--mesh", "1x4", "--precision", precision,
                                  *sizes.cli_flags(sizes.freq)])
        check(rc == 0 and len(metrics) == 1, f"--mesh 1x4 {precision}: rc {rc}")
        m = metrics[0]
        log(f"four {precision}: --mesh 1x4 rc 0 in {wall:.1f} s; filter "
            f"{m['filter']:.3f} s; device {m['device']}")
        check(m["device"]["count"] == 4 and m["device"]["platform"] == "gpu"
              or sizes.rehearsal, f"--mesh 1x4 ran on {m['device']}")
        check(m["precision"] == precision, f"precision {m['precision']}")
        y4 = audio.read_audio(out).samples
        out.unlink()

        t0 = time.perf_counter()
        y1, peak1 = filter_array_streamed(din.samples, plan)
        log(f"four {precision}: one-card filter {time.perf_counter() - t0:.3f}"
            f" s (in memory)")
        scale = 1.0 / peak1 if peak1 > 1.0 else 1.0
        from lowcut.ops import oracle

        d = oracle.max_lsb_error(y4, y1 * np.float32(scale), bits)
        log(f"four {precision}: 1x4 file vs one-card output: {d:.4f} LSB @ "
            f"{bits}-bit")
        check(d <= 1.0, f"1x4 vs one card: {d:.4f} LSB @ {bits}-bit")
        seg = sharded_segment_len(plan, 4, 2)
        seams = [k * seg // 4 for k in range(1, 5)]
        _check_windows(din.samples, y4, taps, _windows(n, seams), scale,
                       bits, f"four {precision} shard seams")


# ----------------------------------------------------------------- main

class Sizes:
    """Production sizes, or tiny ones for the CPU tests of each phase
    (tests/test_chip_smoke.py)."""

    def __init__(self, rehearsal: bool):
        self.rehearsal = rehearsal
        if rehearsal:
            self.fs, self.fs_cd = 8000.0, 8000.0
            self.freq, self.freq_c, self.slope = 100.0, 150.0, 200.0
            self.block = self.cli_block = 1 << 12
            self.headline_s, self.other_s = 3.0, 2.0
        else:
            self.fs, self.fs_cd = FS, 44100.0
            self.freq, self.freq_c, self.slope = FREQ, 40.0, SLOPE
            self.block, self.cli_block = GATE_BLOCK, 0
            self.headline_s = 3600.0        # 1 h
            self.other_s = 1800.0           # 30 min: crosses a segment

    def segment(self, plan) -> int:
        from lowcut.pipeline.stream import default_segment_len

        if self.rehearsal:
            return 8 * plan.hop
        return default_segment_len(plan, channels=2)

    def cli_flags(self, freq: float) -> list[str]:
        """CLI flags for cutoff ``freq``: none beyond the defaults."""
        flags = [] if freq == FREQ else ["-f", f"{freq:g}"]
        if self.slope != SLOPE:
            flags += ["-s", f"{self.slope:g}"]
        if self.cli_block:
            flags += ["--block-size", str(self.cli_block)]
        return flags


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the --mesh 1x4 phase, on four cards")
    args = ap.parse_args(argv)
    sizes = Sizes(rehearsal=False)
    try:
        from lowcut.utils.options import ENGINES
    except ImportError as e:
        print(f"chip_smoke: run from a checkout of lowcut ({e})",
              file=sys.stderr)
        return 1

    try:
        device = phase_device(4 if args.four else 1)
    except Exception as e:  # noqa: BLE001 — no device, no result
        print(f"chip_smoke: {e}", file=sys.stderr)
        return 1

    work = Path(tempfile.mkdtemp(prefix=".chip_smoke_", dir=ROOT))
    first = ("fft", "fourstep")
    phases = ([("four", lambda: phase_four(sizes, work))] if args.four else [
        ("tests", phase_tests),
        ("engines", lambda: phase_engines(sizes, first, TIMED_ROUNDS)),
        ("cli", lambda: phase_cli(sizes, work, device)),
        ("more-engines", lambda: phase_engines(
            sizes, [e for e in ENGINES if e not in first], 0)),
    ])
    failed = []
    try:
        for name, fn in phases:
            log(f"== phase {name}")
            t0 = time.perf_counter()
            try:
                fn()
                log(f"== phase {name}: PASS ({time.perf_counter() - t0:.1f} s)")
            except Exception:  # noqa: BLE001 — report every phase
                traceback.print_exc()
                log(f"== phase {name}: FAIL ({time.perf_counter() - t0:.1f} s)")
                failed.append(name)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    if failed:
        print(f"chip_smoke: failed phases {failed}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
