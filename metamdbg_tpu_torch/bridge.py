"""The stages the port has not ported yet, run through the JAX package.

This is the only module of the port that imports `metamdbg_tpu`. Each
function runs one stage through the JAX package's host code, imported
lazily inside the call, with METAMDBG_TPU_HOST_ONLY=1 set for the duration
of that call only (an environment write that outlived the call would leak
into whatever else shares the process) and no device mesh. The host path
never imports jax; `_host_only` raises if a bridged call did, because the
machine with the GPU has no JAX at all.

Each entry names the ROADMAP.md Queue 1 item whose slice deletes it. When
the last entry is gone, so is this file.
"""

import contextlib
import dataclasses
import os
import sys

_HOST_ONLY = "METAMDBG_TPU_HOST_ONLY"


@contextlib.contextmanager
def _host_only():
    had_jax = "jax" in sys.modules
    old = os.environ.get(_HOST_ONLY)
    os.environ[_HOST_ONLY] = "1"
    try:
        yield
    finally:
        if old is None:
            os.environ.pop(_HOST_ONLY, None)
        else:
            os.environ[_HOST_ONLY] = old
    if not had_jax and "jax" in sys.modules:
        raise RuntimeError("a bridged stage imported jax; the JAX package's "
                           "host path must run without it")


def _params(params):
    """The port's Parameters as the JAX package's (same fields)."""
    from metamdbg_tpu.io import records
    return records.Parameters(**dataclasses.asdict(params))


# ROADMAP Queue 1 item 8 (ONT correction + kernel K4)
def run_read_correction(tmp_dir: str, params, min_identity: float,
                        min_overlap_length: int, n_threads: int):
    with _host_only():
        from metamdbg_tpu.correction import stage
        stage.run_read_correction(tmp_dir, _params(params),
                                  min_identity=min_identity,
                                  min_overlap_length=min_overlap_length,
                                  n_threads=n_threads, mesh=None)
