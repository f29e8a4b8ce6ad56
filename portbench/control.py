"""`python -m portbench.control --workload <cell> --seed <n>`: the control
of a cell's comparison. It makes the cell's inputs as a run does, puts the
reference with one guarantee of the configuration broken (the stage's
`CONTROL_ENV`) in the program's place on the units a run with this seed
would check, and compares them with the reference as a run does. A sound
comparison reads it as not correct. Prints one JSON line: the number
compared and its limit."""

import argparse
import json
import os
import shutil
import sys


def control_run(cell_name: str, seed: int, cell=None, cfg=None,
                bench=None) -> dict:
    import importlib

    from . import gen
    from .run import HERE, ROOT, Context, load_json
    from .stages import check, control, make_units, unit_key

    bench = bench or load_json(ROOT, "BENCHMARK.json")
    entry = next(w for w in bench["workloads"] if w["name"] == cell_name)
    cell = cell or load_json(HERE, "workloads", f"{cell_name}.json")
    cfg = cfg or load_json(HERE, "configs", f"{entry['config']}.json")
    stage = importlib.import_module(f"portbench.stages.{cell['stage']}")
    data = os.path.join(HERE, "data", cell_name,
                        f"{unit_key(cfg, cell)}_{seed}")
    ctx = Context(cell_name, cell, cfg, seed, None, data,
                  os.path.join(HERE, "work", cell_name + ".control"))
    os.makedirs(ctx.data_root, exist_ok=True)
    shutil.rmtree(ctx.work_root, ignore_errors=True)
    os.makedirs(ctx.work_root)
    _, units = make_units(ctx)
    units = [dict(u, turn=0) for u in units]
    rng = gen.rng_for(seed, 7)
    n = min(cell["check_units"], len(units))
    picked = [units[i] for i in
              sorted(rng.choice(len(units), size=n, replace=False).tolist())]
    compared, bad = check(ctx, stage, picked, control(ctx, stage, picked))
    shutil.rmtree(ctx.work_root, ignore_errors=True)
    return {"workload": cell_name, "seed": seed, "units": len(picked),
            "outputs_compared": compared, "mismatched_outputs": len(bad),
            "limit": 0, "differ": bad[:10]}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="portbench.control")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    args = parser.parse_args(argv)
    print(json.dumps(control_run(args.workload, args.seed)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
