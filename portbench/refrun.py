"""`python -m portbench.refrun JOB`: the reference on one unit, in a
process of its own that loads neither torch nor the port
(`stages.run_reference` starts it). JOB is a JSON file: the stage, the
configuration, the unit and its work directory."""

import importlib
import json
import sys


def main(argv=None) -> int:
    from . import reference

    with open((argv or sys.argv[1:])[0]) as f:
        job = json.load(f)
    reference.build()
    stage = importlib.import_module(f"portbench.stages.{job['stage']}")
    stage.reference(job["cfg"], job["unit"], job["work"])
    loaded = sorted(n for n in sys.modules
                    if n.split(".")[0] in ("torch", "metamdbg_tpu_torch"))
    if loaded:
        raise SystemExit("the reference loaded " + ", ".join(loaded[:5]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
