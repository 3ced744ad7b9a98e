# Build/test entry points — this framework's counterpart of the reference's
# OS-detecting Makefile (/root/reference/Makefile:1-53, targets
# all/lowcut/test/clean). The compute path is JAX/XLA (nothing to compile);
# `native` builds the C++ PCM codec fast path; `test` is a real suite, not
# the reference's manual timing smoke run (Makefile:45-49).

PY ?= python

.PHONY: all native test bench clean

all: native

# C++ PCM codec shared library (ctypes; see lowcut/native/).
native:
	rm -f lowcut/native/_pcm_codec.so
	$(PY) -c "from lowcut.native import pcm_codec as p; \
	          assert p.load() is not None, 'native codec build failed'; \
	          print('built', p._SO)"

test:
	$(PY) -m pytest tests/ -x -q

# North-star benchmark (one JSON line on stdout; details on stderr).
bench:
	$(PY) bench.py

clean:
	rm -f lowcut/native/_pcm_codec.so
	find . -name '__pycache__' -type d -prune -exec rm -rf {} +
