"""`python -m portbench --workload <cell> --seed <n> --seconds <s> --trace
<0|1>`: one run of one cell (portbench/run.py)."""

import sys

from portbench.run import main

if __name__ == "__main__":
    sys.exit(main())
