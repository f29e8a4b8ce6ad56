"""`python -m portbench.make JOB`: makes the samples a run's set-up lacks,
in a process of its own (`stages.make_units` starts it). JOB is a JSON
file: the stage, the cell, the configuration, the seed, the data
directory and the samples [(name, index, strain, Mbp)]."""

import json
import sys


def main(argv=None) -> int:
    from .stages import make_missing

    with open((argv or sys.argv[1:])[0]) as f:
        make_missing(json.load(f))
    return 0


if __name__ == "__main__":
    sys.exit(main())
