"""Time variants of a port kernel's source beside the committed one.

Run from the root of a checkout, on a machine with an NVIDIA GPU:

    python3 tools/kernel_variants.py sketch \
        "threads 256=constexpr int kThreads = 128;=>constexpr int kThreads = 256;"
    python3 tools/kernel_variants.py chain_dp \
        "team 1=constexpr int kTeam = 8;=>constexpr int kTeam = 1;"

Each variant is NAME=OLD=>NEW[;;OLD=>NEW...]: text replacements applied to
metamdbg_tpu_torch/csrc/<kernel>.cu (each OLD must occur exactly once;
the shared headers, csrc/*.cuh, are included as they are). Every variant
and the committed source are built with the port's nvcc flags into a
temporary directory, held bit-identical to the plain torch version, and
timed with chip_smoke.py's method (CUDA events around 20 back-to-back
launches on outputs allocated once, the median of 3) in turns, committed
source first and last, on phase 3's inputs: K1 at (512, 16384),
l = 15 and densities 0.005 and 0.1; KW on 4,194,304 windows at w = 4, 16,
40 and 123 (dense), shuffled at w = 16 and with per-window widths 1..16,
on (2^20, 24) row slices, on 24,576 windows at w = 32 (a launch of the
ladder's size), on 4,000 whole unitigs of up to 20,000 words, and on the
planes of a ladder (10,000 reads of ~60 minimizers at w = 4..123, 120
launches, timed as a sum), the same planes in the segmented mode (one
launch per width over the reads' stream on the card, 120 launches) and one
segmented launch over phase 3b's reads-like stream at w = 16 and 40; K3
(chain_contig) on phase 3d's groups and on
groups shaped like toBasespace's call (10,180 of 2-77 anchors); K4
(chain_dp) on 100,000 of phase 3e's groups plus a 10,003-anchor one at
band 62, and on the ONT asm's own call where chip_smoke.py saved it
(chip_inputs/chain_dp_main.pt), else on groups of its shape (666,780 of
3-36 anchors). Every build is launched through the wrapper's
own `_enqueue`, with its `_lib` pointing at the build and the wrapper's
`_bind` declaring the C interface, so a variant keeps the committed
source's interface. Prints one line per variant and shape, and `-Xptxas
-v`'s registers and spills for each build.
"""

import argparse
import contextlib
import ctypes
import os
import subprocess
import sys
import tempfile

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402
from metamdbg_tpu_torch.kernels import build  # noqa: E402
from metamdbg_tpu_torch.kernels import chain as kchain  # noqa: E402
from metamdbg_tpu_torch.kernels import chain_dp as k4  # noqa: E402
from metamdbg_tpu_torch.kernels import sketch as ksketch  # noqa: E402
from metamdbg_tpu_torch.kernels import window_hash as kw  # noqa: E402

MODULES = {"sketch": ksketch, "window_hash": kw, "chain_contig": kchain,
           "chain_dp": k4}


def _build(module, name, text, work):
    src = os.path.join(work, f"{name}.cu")
    with open(src, "w") as f:
        f.write(text)
    out = os.path.join(work, f"lib{name}.so")
    cmd = [build.nvcc_path(), *build.NVCC_FLAGS, "-Xptxas", "-v",
           "-I", build.CSRC_DIR, "-o", out, src]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        sys.exit(f"{name}: nvcc failed\n{proc.stderr[-3000:]}")
    regs = [line.split("info    : ")[-1] for line in proc.stderr.splitlines()
            if "registers" in line or "spill" in line]
    print(f"{name}: " + "; ".join(r.strip() for r in regs))
    return module._bind(ctypes.CDLL(out))


@contextlib.contextmanager
def _using(module, lib):
    """The wrapper `module` launches from `lib` inside the block."""
    real = module._lib
    module._lib = lambda: lib
    try:
        yield
    finally:
        module._lib = real


def _k1_cases(dev):
    from metamdbg_tpu_torch.sketch.batch import TILE_LEN, TILE_ROWS

    l, nk = cs.L_MIN, TILE_LEN - cs.L_MIN + 1
    for i, density in enumerate((0.005, 0.1)):
        cap = ksketch.compact_cap(nk, density)
        codes = torch.from_numpy(cs._tiles(TILE_ROWS, TILE_LEN, l,
                                           seed=100 + i)).to(dev)
        ref = ksketch.sketch_tiles_reference(codes, l, density, cap)
        out = ksketch._launch(codes, l, density, cap)

        def check(out=out, ref=ref, cap=cap):
            if not torch.equal(out[3], ref[3]):
                return False
            live = (torch.arange(cap, device=dev)[None, :]
                    < ref[3].to(torch.int64).clamp(max=cap)[:, None])
            return all(torch.equal(g.to(torch.int64)[live],
                                   w.to(torch.int64)[live])
                       for g, w in zip(out[:3], ref[:3]))
        yield f"density {density}", [(check, (codes, l, density, cap, out))]


def _kw_cases(dev):
    cat = torch.from_numpy(cs._kw_stream(cs.KW_STREAM, seed=300)).to(dev)
    rows = torch.from_numpy(np.random.default_rng(1).integers(
        0, 1 << 32, size=(1 << 20, 24), dtype=np.int64)).to(dev).view(-1)
    rng = np.random.default_rng(2)
    shapes = [(f"dense w={w}", cat, torch.arange(cs.KW_STREAM - w + 1,
                                                 device=dev), w, True)
              for w in (4, 16, 40, 123)]
    shapes += [
        ("rows w=23", rows, torch.arange(1 << 20, device=dev) * 24 + 1, 23,
         False),
        ("shuffled w=16", cat, torch.from_numpy(
            rng.permutation(cs.KW_STREAM - 15)).to(dev), 16, True),
        ("per-window widths 1..16", cat,
         torch.arange(cs.KW_STREAM - 16, device=dev),
         torch.from_numpy(rng.integers(1, 17, cs.KW_STREAM - 16)).to(dev),
         True),
        # a launch of the ladder's size: fewer blocks than the card has SMs
        ("dense w=32, 24,576 windows", cat, torch.arange(24_576, device=dev),
         32, True)]
    widths = torch.from_numpy(rng.choice(np.unique(np.geomspace(
        1, cs.KW_UNITIG_MAX, 24).astype(np.int64)), cs.KW_UNITIGS)).to(dev)
    ucat = torch.from_numpy(cs._kw_stream(int(widths.sum()), seed=303)).to(
        dev)
    shapes.append((f"{cs.KW_UNITIGS} unitigs up to {cs.KW_UNITIG_MAX} words",
                   ucat, torch.cumsum(widths, 0) - widths, widths, False))
    for what, c, starts, w, normalize in shapes:
        yield what, [_kw_launch(c, starts, w, normalize)]
    # the ladder's planes: every window of 10,000 reads of ~60 minimizers
    # (a 4 Mb x 30x HiFi read set at density 0.005) at each width 4..123,
    # one launch per width, as the multiplex passes sweep them
    lens = np.clip(rng.normal(60, 20, 10_000), 1, None).astype(np.int64)
    rcat = torch.from_numpy(cs._kw_stream(int(lens.sum()), seed=304)).to(
        dev)
    from metamdbg_tpu_torch.count.kminmers import window_starts
    tl = torch.from_numpy(lens).to(dev)
    yield "ladder planes w=4..123 (120 launches)", [
        _kw_launch(rcat, window_starts(tl, w)[0], w, True)
        for w in range(4, 124)]
    # the same planes in the segmented mode, and phase 3b's reads
    reads = kw.Stream(np.split(cs._kw_stream(int(lens.sum()), seed=304)
                               .astype(np.uint32), np.cumsum(lens)[:-1]))
    reads.to(dev)
    yield "ladder planes segmented w=4..123 (120 launches)", [
        _kw_segments_launch([kw.Segment(reads, w)], dev)
        for w in range(4, 124)]
    reads = kw.Stream(cs._kw_reads(cs.KW_STREAM, seed=310)).to(dev)
    for w in (16, 40):
        yield f"reads-like segmented w={w}", [
            _kw_segments_launch([kw.Segment(reads, w)], dev)]


def _kw_segments_launch(segments, dev):
    """(check, _enqueue_segments' arguments, its name) of one segmented KW
    launch into a fresh output."""
    segs, n_total, table = kw._prepare(segments, dev)
    ref = kw.hash_segments_reference(segs, n_total)
    out = torch.empty(2 * n_total, dtype=torch.int64, device=dev)
    live = sum(1 for s in segs if s.n_win)
    return ((lambda: torch.equal(out, ref)),
            (table, live, kw._n_tiles(segs), out), "_enqueue_segments")


def _kw_launch(c, starts, w, normalize):
    """(check, _enqueue's arguments) of one KW launch into a fresh
    output."""
    n = starts.numel()
    ref = kw.hash_windows_reference(c, starts, w, normalize)
    out = torch.empty(2 * n + 1, dtype=torch.int64, device=c.device)
    token = 4 << 40

    def check():
        return (torch.equal(out[:n], ref[0])
                and torch.equal(out[n:2 * n], ref[1])
                and int(out[2 * n]) - token not in (1, 2))
    return check, (c, starts, w, normalize, out, token)


def _chain_contig_cases(dev):
    from metamdbg_tpu_torch.basespace.contig_mapper import _d_r_max

    d_r_max = _d_r_max(float(1.0 / np.float32(0.005)))
    rng = np.random.default_rng(6)
    shapes = [
        ("phase 3d", np.concatenate([rng.integers(2, cs.CHAIN_MAX_LEN + 1,
                                                  cs.CHAIN_GROUPS),
                                     cs.CHAIN_LONG])),
        ("toBasespace-shaped 10,180 groups of 2-77",
         rng.integers(2, 78, 10_180))]
    for what, lengths in shapes:
        inputs = [torch.from_numpy(a).to(dev)
                  for a in cs.chain_groups(lengths, seed=7)]
        ref = kchain.chain_contig_reference(*inputs, d_r_max)
        out = kchain._launch(*inputs, d_r_max)

        def check(out=out, ref=ref):
            return torch.equal(out[0].view(torch.int32),
                               ref[0].view(torch.int32)) and all(
                torch.equal(a, b) for a, b in zip(out[1:], ref[1:]))
        yield what, [(check, (*inputs, d_r_max, out))]


def _chain_dp_cases(dev):
    rng = np.random.default_rng(8)
    main_path = cs.CHAIN_DP_SAVED
    shapes = [("100,000 phase 3e groups + 10,003 anchors, band 62",
               np.concatenate([rng.integers(3, cs.CHAIN_DP_MAX_LEN + 1,
                                            100_000), [10_000]]), 62)]
    if not os.path.exists(main_path):
        shapes.append(("ONT-shaped 666,780 groups of 3-36, band 62",
                       np.minimum(rng.geometric(1 / 6.3, 666_780) + 2, 36),
                       62))
    for what, lengths, band in shapes:
        arrays = cs.chain_dp_groups(lengths, seed=9)
        yield what, [_chain_dp_launch(
            cs._k4_inputs([torch.from_numpy(a).to(dev) for a in arrays]),
            band)]
    if os.path.exists(main_path):
        saved = torch.load(main_path)
        yield (f"the ONT asm's call, band {saved['band']}",
               [_chain_dp_launch([t.to(dev) for t in saved["inputs"]],
                                 saved["band"])])


def _chain_dp_launch(kin, band):
    """(check, _enqueue's arguments) of one K4 launch into a fresh output."""
    ref = k4.chain_dp_reference(*kin, band)
    out = k4._launch(*kin, band)

    def check():
        return torch.equal(out.scores.view(torch.int32),
                           ref.scores.view(torch.int32)) and all(
            torch.equal(getattr(out, f), getattr(ref, f))
            for f in ("parents", "best_index", "chain_len", "chain_score",
                      "chain_pos"))
    return check, (*kin, band, out)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("kernel", choices=tuple(MODULES))
    ap.add_argument("variants", nargs="*")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs an NVIDIA GPU")
    dev = torch.device("cuda", 0)
    module = MODULES[args.kernel]
    text = open(os.path.join(build.CSRC_DIR, f"{args.kernel}.cu")).read()
    work = tempfile.mkdtemp(prefix="variants_")
    libs = {"committed": _build(module, "committed", text, work)}
    for spec in args.variants:
        name, _, edits = spec.partition("=")
        vtext = text
        for edit in edits.split(";;"):
            old, new = edit.split("=>")
            if vtext.count(old) != 1:
                sys.exit(f"{name}: {old!r} occurs {vtext.count(old)} times")
            vtext = vtext.replace(old, new)
        libs[name] = _build(module, name.replace(" ", "_"), vtext, work)
    cases = {"sketch": _k1_cases, "window_hash": _kw_cases,
             "chain_contig": _chain_contig_cases,
             "chain_dp": _chain_dp_cases}[args.kernel](dev)
    for what, launches in cases:
        runners = {name: _runner(module, lib, launches)
                   for name, lib in libs.items()}
        times = {}
        for name, run in runners.items():
            run()
            torch.cuda.synchronize()
            if not all(check() for check, *_ in launches):
                sys.exit(f"{name} {what}: differs from the plain version")
            times[name] = [cs._time_ms(run)]
        # the committed source again, last
        times["committed"].append(cs._time_ms(runners["committed"]))
        for name, t in times.items():
            print(f"{args.kernel} {what} {name}: "
                  f"{' / '.join(f'{x:.4f}' for x in t)} ms, bit-identical")


def _runner(module, lib, launches):
    """Every launch of a case through the wrapper's `_enqueue`, or the
    function a launch names third."""
    def run():
        with _using(module, lib):
            for _, args, *fn in launches:
                getattr(module, fn[0] if fn else "_enqueue")(*args)
    return run


if __name__ == "__main__":
    main()
