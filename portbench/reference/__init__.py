"""The benchmark's reference: a copy of the JAX package's host route for
read selection and toBasespace, run on the CPU, importing neither JAX nor
the JAX package nor the port.

Copied from `metamdbg_tpu` (the original the port was held against byte
for byte) with its device branches removed: the sketch and the contig
chain DP run their host versions (the native engine, or numpy), the polish
fan-out is one host, and the logger is "portbench.reference". The native
engines (`native/`, copied from the repo's `native/`) are built into that
directory without OpenMP (see its Makefile); the host fan-out is the JAX
package's forked workers (`utils/forkmap.py`). The POA, overlap and window-cut engines are the same C++ the
port builds, so the comparison does not check those engines independently
(see PERF.md).
"""

import os
import subprocess

NATIVE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "native")


def build():
    """Builds the native engines into `native/` where they are missing
    (a checkout's first run)."""
    subprocess.run(["make", "-s", "-C", NATIVE], check=True,
                   stdout=subprocess.DEVNULL)
