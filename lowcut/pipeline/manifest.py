"""Resumable batch manifest.

The reference aborts a batch mid-way on any error, abandoning the remaining
files and possibly leaving partial outputs (/root/reference/main.cp:132-147,
157-160; SURVEY.md §5 "failure detection"). This framework:

- writes outputs atomically (audio/file.py: temp + rename), so no partial
  files exist, and
- records per-file completion in a manifest JSON next to the destination
  directory, so re-running the same batch skips completed files
  (the manifest IS the checkpoint — there is no model state to checkpoint).
"""

from __future__ import annotations

import json
import os
import tempfile
import threading
from pathlib import Path

MANIFEST_NAME = ".lowcut_manifest.json"


class BatchManifest:
    """Thread-safe: ``mark_done`` is called from the batch pipeline's
    writer threads (pipeline/batch.py)."""

    def __init__(self, dest_dir: Path, options_fingerprint: str):
        self.path = Path(dest_dir) / MANIFEST_NAME
        self.fingerprint = options_fingerprint
        self.done: dict[str, bool] = {}
        self._lock = threading.Lock()
        if self.path.exists():
            try:
                data = json.loads(self.path.read_text())
                if data.get("options") == options_fingerprint:
                    self.done = dict(data.get("done", {}))
            except (json.JSONDecodeError, OSError):
                pass  # corrupt manifest: start fresh

    def is_done(self, input_path) -> bool:
        with self._lock:
            return self.done.get(str(input_path), False)

    def mark_done(self, input_path) -> None:
        with self._lock:
            self.done[str(input_path)] = True
            self._flush()

    def _flush(self) -> None:
        # Unique temp name + atomic replace (lock held by callers).
        fd, tmp = tempfile.mkstemp(dir=str(self.path.parent),
                                   prefix=".lowcut_manifest_")
        try:
            with os.fdopen(fd, "w") as f:
                json.dump({"options": self.fingerprint, "done": self.done},
                          f, indent=1)
            os.replace(tmp, self.path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise

    def clear(self) -> None:
        if self.path.exists():
            self.path.unlink()


def options_fingerprint(opts) -> str:
    """Stable fingerprint of the output-relevant options: resuming with
    different filter settings must not skip files. Includes ``engine``
    because engines produce bit-different float32 roundings — a resume
    that flips it must not mix outputs in one batch directory."""
    return json.dumps(
        [opts.filter_type, opts.freq, opts.freq_hi, opts.slope,
         opts.normalize, opts.precision, opts.block_size,
         getattr(opts, "engine", "auto")]
    )
