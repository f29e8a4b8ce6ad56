"""Time a parent commit's K1, KW, K3 and K4 beside the current ones on one
NVIDIA GPU, and the HiFi asm of both, in turns, under torch.profiler.

Run from the root of a checkout, with the parent commit's package and its
native/ unpacked into a directory that .gitignore lists:

    mkdir -p chip_checkout/parent
    git archive HEAD~1 metamdbg_tpu_torch native | tar -x -C chip_checkout/parent
    python3 tools/kernel_ab.py chip_checkout/parent

The parent's package is imported from that directory under another name
(`parent_port`); its kernels are built from its own sources by its own
build module and launched through its own wrappers, so its C interface
comes with its source. Each side launches through its wrapper's
`_enqueue`, into outputs allocated once, where the wrapper has one, else
through `_launch`, whose allocations a CUDA graph makes once, at capture.
Both are timed by chip_smoke._time_ms (CUDA events around a CUDA graph of
20 launches, the median of 3) in turns: parent, current, current, parent;
each side's figure is the median of its two. The parent's outputs must
equal the current kernel's, which chip_smoke.py holds against the plain
versions. A current KW launch in the segmented mode is set against the
parent's explicit-starts kernel on the same windows: one parent launch per
segment, on the stream widened to int64 and a start per window.

1. K1 on chip_smoke.py phase 3's (512, 16384) tiles at the main path's
   three densities;
2. KW on phase 3b's stream of 4,194,304 minimizers, dense at w = 16, 61
   and 123, shuffled at w = 16, and on (2^20, 24) row slices at w = 23;
   and on phase 3b's reads-like stream at w = 16 and 40, the current
   kernel in the segmented mode; the host clock per
   `count/kminmers.flat_window_hashes` call of each package, its result
   read back, at 64, 2,000 and 31,000 windows;
3. K3 on phase 3d's groups and K4 on phase 3e's at band 62;
4. the HiFi asm of phase 4 (`asm --device cuda --threads 1`, the JAX
   package refused) four times, parent, current, current, parent, each
   through its own package's entry point under torch.profiler: the asm
   wall, the ladder (k*_createGraph + k*_generateContigs, and each) and
   each phase of the multiplex passes summed (the `multiplex.<phase>`
   spans of utils/spans.py, or MultiplexPass.phase_seconds in a package
   older than the spans),
   the host clock in the `flat_window_hashes` and `PairTable.lookup`
   calls of their phases after the count,
   the device's busy time and idle share, KW's launches and device time;
   every KW launch of each side's first run is recorded, and the sum of
   their bounds (chip_smoke.kw_call_bound, the stream at 4 bytes a word
   for both) printed beside the device time;
5. the current asm's own launches again: every K1 launch and the KW
   launches of chip_smoke.kw_replay_set, with the sums of both sides'
   times and of the bounds, and the K3 call; and the ONT asm's K4 call
   where chip_smoke.py phase 8 saved it in this checkout (chip_inputs/, so
   run chip_smoke.py first in the same call).
"""

import concurrent.futures
import contextlib
import importlib
import importlib.util
import os
import shutil
import statistics
import sys
import tempfile
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402

PARENT = "parent_port"


def load_parent(root):
    """(sketch, window_hash, chain, chain_dp): the parent's kernel wrappers,
    from the package in `root`, imported as `parent_port`."""
    pkg = os.path.join(os.path.abspath(root), "metamdbg_tpu_torch")
    spec = importlib.util.spec_from_file_location(
        PARENT, os.path.join(pkg, "__init__.py"),
        submodule_search_locations=[pkg])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[PARENT] = mod
    spec.loader.exec_module(mod)
    return tuple(importlib.import_module(f"{PARENT}.kernels.{name}")
                 for name in ("sketch", "window_hash", "chain", "chain_dp"))


def turns(parent_fn, fn):
    """(parent ms, current ms), timed parent, current, current, parent."""
    p1, c1, c2, p2 = (cs._time_ms(f) for f in (parent_fn, fn, fn, parent_fn))
    return statistics.median([p1, p2]), statistics.median([c1, c2])


def k1_run(mod, codes, l, density, cap):
    """(a launch of `mod`'s K1 that does not wait, its outputs)."""
    out = mod._launch(codes, l, density, cap)
    if hasattr(mod, "_enqueue"):
        return (lambda: mod._enqueue(codes, l, density, cap, out)), out
    return (lambda: mod._launch(codes, l, density, cap)), out


def kw_run(mod, cat, starts, w, normalize):
    """A launch of `mod`'s KW that does not wait."""
    if hasattr(mod, "_enqueue"):
        out = torch.empty(2 * starts.numel() + 1, dtype=torch.int64,
                          device=cat.device)
        return lambda: mod._enqueue(cat, starts, w, normalize, out)
    return lambda: mod._launch(cat, starts, w, normalize)


def k1_ab(what, pk1, codes, l, density, cap):
    """Both K1s on one launch's inputs: equal outputs, or fail; returns
    (parent ms, current ms, bound)."""
    from metamdbg_tpu_torch.kernels import sketch as ksketch

    fn, out = k1_run(ksketch, codes, l, density, cap)
    pfn, pout = k1_run(pk1, codes, l, density, cap)
    torch.cuda.synchronize()
    live = (torch.arange(cap, device=codes.device)[None, :]
            < out[3].to(torch.int64).clamp(max=cap)[:, None])
    if not torch.equal(out[3], pout[3]) or not all(
            torch.equal(a.to(torch.int64)[live], b.to(torch.int64)[live])
            for a, b in zip(out[:3], pout[:3])):
        cs.fail(f"ab sketch_tiles {what}: the parent's kernel differs from "
                f"the current one")
    return (*turns(pfn, fn),
            cs.k1_bound(codes.shape[0], codes.shape[1], l, cap))


def kw_ab(what, pkw, cat, starts, w, normalize):
    """Both KWs on one launch's inputs: equal outputs, or fail; returns
    (parent ms, current ms, bound)."""
    from metamdbg_tpu_torch.kernels import window_hash as kw

    got = pkw.hash_windows(cat, starts, w, normalize)
    want = kw.hash_windows(cat, starts, w, normalize)
    if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
        cs.fail(f"ab window_hash {what}: the parent's kernel differs from "
                f"the current one")
    return (*turns(kw_run(pkw, cat, starts, w, normalize),
                   kw_run(kw, cat, starts, w, normalize)),
            cs.kw_launch_bound(cat.numel(), starts, w, normalize))


def kw_segments_ab(what, pkw, segs, n_total):
    """The current segmented launch against the parent's explicit-starts
    kernel on the same windows (one launch per segment): equal outputs, or
    fail; returns (parent ms, current ms, the current launch's bound)."""
    from metamdbg_tpu_torch.kernels import window_hash as kw

    out = kw._launch_segments(segs, n_total)
    parent = []
    for s in segs:
        if not s.n_win:
            continue
        cat = s.words.to(torch.int64) & 0xFFFFFFFF
        starts = kw.segment_starts(s)
        h1, h2 = pkw.hash_windows(cat, starts, s.w, s.normalize)
        if not (torch.equal(h1, out[s.out:s.out + s.n_win]) and torch.equal(
                h2, out[n_total + s.out:n_total + s.out + s.n_win])):
            cs.fail(f"ab window_hash {what}: the parent's kernel differs "
                    f"from the current one")
        parent.append(kw_run(pkw, cat, starts, s.w, s.normalize))
    return (*turns(lambda: [fn() for fn in parent],
                   cs._kw_segments_timer(segs, n_total)),
            cs.kw_segments_bound(segs))


def k3_ab(what, pk3, inputs, d_r_max):
    """Both K3s on one call's inputs: equal outputs, or fail; returns
    (parent ms, current ms, bound)."""
    from metamdbg_tpu_torch.kernels import chain as kchain

    runs = []
    for mod in (pk3, kchain):
        out = mod._launch(*inputs, d_r_max)
        runs.append(((lambda mod=mod, out=out:
                      mod._enqueue(*inputs, d_r_max, out)), out))
    torch.cuda.synchronize()
    (pfn, pout), (fn, out) = runs
    if not (torch.equal(pout[0].view(torch.int32), out[0].view(torch.int32))
            and all(torch.equal(a, b) for a, b in zip(pout[1:], out[1:]))):
        cs.fail(f"ab chain_contig {what}: the parent's kernel differs from "
                f"the current one")
    return (*turns(pfn, fn),
            cs.chain_contig_bound(np.diff(inputs[4].cpu().numpy())))


def k4_ab(what, pk4, kin, band):
    """Both K4s on one call's int32 inputs: equal outputs, or fail; returns
    (parent ms, current ms, bound)."""
    from metamdbg_tpu_torch.kernels import chain_dp as k4

    runs = []
    for mod in (pk4, k4):
        out = mod._launch(*kin, band)
        runs.append(((lambda mod=mod, out=out:
                      mod._enqueue(*kin, band, out)), out))
    torch.cuda.synchronize()
    (pfn, pout), (fn, out) = runs
    if not all(torch.equal(getattr(pout, f).view(torch.int32),
                           getattr(out, f).view(torch.int32))
               for f in cs.K4_FIELDS):
        cs.fail(f"ab chain_dp {what}: the parent's kernel differs from the "
                f"current one")
    return (*turns(pfn, fn),
            cs.chain_dp_bound(np.diff(kin[4].cpu().numpy()), band))


def _line(what, p_ms, ms, b):
    return (f"{what}: parent {p_ms:.4f} ms, current {ms:.4f} ms "
            f"({ms / p_ms - 1:+.1%}), bound {b[0]:.4f} ms ({b[1]}): "
            f"{b[0] / ms:.1%} of the bound (parent {b[0] / p_ms:.1%})")


def synthetic_phase(dev, pk1, pkw, pk3, pk4):
    for i in range(len(cs.DENSITIES)):
        codes, density, cap = cs.k1_case(i, dev)
        what = f"(512, 16384) l={cs.L_MIN} density={density}"
        print("ab sketch_tiles " + _line(
            what, *k1_ab(what, pk1, codes, cs.L_MIN, density, cap)))
    rng = np.random.default_rng(305)
    cat = torch.from_numpy(cs._kw_stream(cs.KW_STREAM, seed=300)).to(dev)
    rows = torch.from_numpy(rng.integers(
        0, 1 << 32, size=(cs.KW_ROWS, cs.KW_ROW_K), dtype=np.int64)).to(
        dev).view(-1)
    k = cs.KW_ROW_K
    shapes = [(f"dense w={w} normalize", cat,
               torch.arange(cs.KW_STREAM - w + 1, device=dev), w, True)
              for w in (16, 61, 123)]
    shapes += [
        ("shuffled starts w=16 normalize", cat, torch.from_numpy(
            rng.permutation(cs.KW_STREAM - 15)).to(dev), 16, True),
        (f"rows ({cs.KW_ROWS}, {k}) first=1 w={k - 1} raw", rows,
         torch.arange(cs.KW_ROWS, device=dev) * k + 1, k - 1, False)]
    for what, c, starts, w, normalize in shapes:
        print(f"ab window_hash {starts.numel()} windows " + _line(
            what, *kw_ab(what, pkw, c, starts, w, normalize)))
    from metamdbg_tpu_torch.kernels import window_hash as kw

    reads = kw.Stream(cs._kw_reads(cs.KW_STREAM, seed=310)).to(dev)
    for w in (16, 40):
        segs, n_total, _ = kw._prepare([kw.Segment(reads, w)], dev)
        what = (f"reads-like stream ({len(reads)} sequences) w={w} "
                f"normalize, current segmented")
        print(f"ab window_hash {n_total} windows " + _line(
            what, *kw_segments_ab(what, pkw, segs, n_total)))
    flat_window_hashes_ab(dev)
    from metamdbg_tpu_torch.basespace.contig_mapper import _d_r_max

    rng = np.random.default_rng(400)
    lengths = np.concatenate([rng.integers(2, cs.CHAIN_MAX_LEN + 1,
                                           cs.CHAIN_GROUPS), cs.CHAIN_LONG])
    rng.shuffle(lengths)
    inputs = [torch.from_numpy(a).to(dev)
              for a in cs.chain_groups(lengths, seed=401)]
    d_r_max = _d_r_max(float(1.0 / np.float32(0.005)))
    what = f"phase 3d's {lengths.size} groups"
    print("ab chain_contig " + _line(what, *k3_ab(what, pk3, inputs,
                                                  d_r_max)))
    rng = np.random.default_rng(500)
    lengths = np.concatenate([rng.integers(3, cs.CHAIN_DP_MAX_LEN + 1,
                                           cs.CHAIN_DP_GROUPS),
                              cs.CHAIN_LONG])
    rng.shuffle(lengths)
    kin = cs._k4_inputs([torch.from_numpy(a).to(dev)
                         for a in cs.chain_dp_groups(lengths, seed=501)])
    what = f"phase 3e's {lengths.size} groups, band {cs.CHAIN_DP_TIMED}"
    print("ab chain_dp " + _line(what, *k4_ab(what, pk4, kin,
                                              cs.CHAIN_DP_TIMED)))


def flat_window_hashes_ab(dev):
    """Host clock per `count/kminmers.flat_window_hashes` call of each side,
    its result read back as the ladder's callers read theirs, on host
    sequences of the sizes the multiplex passes' later phases hash (tens
    to tens of thousands of windows), in turns."""
    from metamdbg_tpu_torch.count import kminmers

    pkm = importlib.import_module(f"{PARENT}.count.kminmers")
    rng = np.random.default_rng(306)
    for n_seqs, length, w in ((64, 40, 40), (100, 60, 41), (1000, 70, 40)):
        seqs = [rng.integers(0, 1 << 32, size=length, dtype=np.uint64)
                .astype(np.uint32) for _ in range(n_seqs)]
        fns = [lambda mod=mod: mod.flat_window_hashes(seqs, w, dev)[0].cpu()
               for mod in (pkm, kminmers)]
        if not torch.equal(fns[0](), fns[1]()):
            cs.fail("ab flat_window_hashes: the parent's result differs")
        p1, c1, c2, p2 = (cs._host_ms(fns[i]) for i in (0, 1, 1, 0))
        n_win = n_seqs * (length - w + 1)
        print(f"ab flat_window_hashes {n_seqs} sequences of {length} words, "
              f"w={w} ({n_win} windows): host clock per call, result read "
              f"back: parent {statistics.median([p1, p2]):.4f} ms, current "
              f"{statistics.median([c1, c2]):.4f} ms")


def profile_summary(tag, prof, wall):
    """Device time in all and by kernel from a torch.profiler run, and the
    idle share of the wall; returns (busy s, KW's device ms, KW's
    launches seen by the profiler)."""
    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0))

    events = sorted(prof.key_averages(), key=dev_us, reverse=True)
    busy_s = sum(dev_us(e) for e in events) / 1e6
    print(f"ab {tag} profile: device busy {busy_s:.4f} s of a {wall:.1f} s "
          f"wall, idle {1 - busy_s / wall:.4%}")
    for e in events[:8]:
        print(f"ab {tag} profile: {dev_us(e) / 1e3:.2f} ms, {e.count} calls: "
              f"{e.key[:90]}")
    kw_ms = kw_n = 0
    for name in ("sketch_tiles_kernel", "window_hash", "chain_contig_kernel",
                 "chain_dp_kernel"):
        own = [e for e in events if name in e.key and e.count
               and dev_us(e) > 0]
        ms, n = sum(dev_us(e) for e in own) / 1e3, sum(e.count for e in own)
        print(f"ab {tag} profile: {name}: {ms:.4f} ms of device time in "
              f"{n} launches")
        if name == "window_hash":
            kw_ms, kw_n = ms, n
    return busy_s, kw_ms, kw_n


def asm_run(work, dev, fq, pkg, tag, record):
    """The HiFi asm through `pkg`'s Pipeline, as `asm --in-hifi FQ
    --device cuda --threads 1` builds it (the package's __main__ imports
    the installed name, not `pkg`), under torch.profiler; returns (its
    numbers, and when `record` its recorded (KW, K1, K3) launches, KW's as
    chip_smoke.KWRecorder keeps them)."""
    pipeline = importlib.import_module(f"{pkg}.pipeline.asm").Pipeline
    parallel = importlib.import_module(f"{pkg}.parallel")
    kw, ksketch, kchain = (importlib.import_module(f"{pkg}.kernels.{m}")
                           for m in ("window_hash", "sketch", "chain"))
    mplex = importlib.import_module(f"{pkg}.graph.multiplex")
    try:
        spans = importlib.import_module(f"{pkg}.utils.spans")
    except ImportError:
        spans = None
    phases, passes = {}, []
    real_run = mplex.MultiplexPass.run

    def run(self):
        if spans is None:
            real_run(self)
            seconds = self.phase_seconds
        else:
            with spans.span("kernel_ab.pass") as s:
                real_run(self)
            seconds = {key.split(".", 1)[1]: dt
                       for key, dt in s.counts.items()
                       if key.startswith("multiplex.")}
        passes.append(self.k)
        for name, dt in seconds.items():
            phases[name] = phases.get(name, 0.0) + dt

    # the host clock inside the window hashes and table lookups of the
    # multiplex passes' phases after the count (the lookups wait for the
    # card, and so for the hashes)
    calls = {"flat_window_hashes": [0, 0.0], "PairTable.lookup": [0, 0.0]}
    pair_table = mplex.PairTable
    real = {"flat_window_hashes": mplex.flat_window_hashes,
            "PairTable.lookup": pair_table.lookup,
            "count": mplex.MultiplexPass._count_kminmers}
    counting = [False]

    def count(self):
        counting[0] = True
        try:
            real["count"](self)
        finally:
            counting[0] = False

    def timed(name):
        def fn(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return real[name](*args, **kwargs)
            finally:
                if not counting[0]:
                    calls[name][0] += 1
                    calls[name][1] += time.perf_counter() - t0
        return fn

    out = os.path.join(work, tag)
    os.environ["METAMDBG_TPU_KEEP_TMP"] = "1"
    prof = torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CUDA])
    kw.reset_counts()
    recorders = ((cs.KWRecorder(kw) if hasattr(kw, "_launch_segments")
                  else cs.LaunchRecorder(kw)), cs.LaunchRecorder(ksketch),
                 cs.LaunchRecorder(kchain)) if record else ()
    mplex.MultiplexPass.run = run
    mplex.MultiplexPass._count_kminmers = count
    mplex.flat_window_hashes = timed("flat_window_hashes")
    pair_table.lookup = timed("PairTable.lookup")
    try:
        with contextlib.ExitStack() as stack:
            for r in recorders:
                stack.enter_context(r)
            prof.start()
            t0 = time.perf_counter()
            try:
                pipeline(out, [fq], platform="hifi", device=dev.type,
                         n_threads=1).run()
            finally:
                parallel.shutdown()
            wall = time.perf_counter() - t0
            prof.stop()
    finally:
        mplex.MultiplexPass.run = real_run
        mplex.MultiplexPass._count_kminmers = real["count"]
        mplex.flat_window_hashes = real["flat_window_hashes"]
        pair_table.lookup = real["PairTable.lookup"]
    walls, rss = cs._stage_walls(out)
    busy_s, kw_ms, kw_seen = profile_summary(tag, prof, wall)
    res = {"wall": wall, "createGraph": walls["k*_createGraph"],
           "generateContigs": walls["k*_generateContigs"],
           **{f"multiplex {name}": dt for name, dt in phases.items()},
           **{f"multiplex {name} s": c[1] for name, c in calls.items()},
           "kw_ms": kw_ms, "kw_launches": kw.launches, "busy_s": busy_s,
           "idle": 1 - busy_s / wall}
    res["ladder"] = res["createGraph"] + res["generateContigs"]
    sites = getattr(kw, "sites", None)
    print(f"ab {tag}: asm wall {wall:.1f} s under torch.profiler, peak RSS "
          f"{rss}; ladder {res['ladder']:.2f} s (createGraph "
          f"{res['createGraph']:.2f} s, generateContigs "
          f"{res['generateContigs']:.2f} s); the {len(passes)} multiplex "
          f"passes' phases summed (s) "
          + ", ".join(f"{n} {dt:.3f}" for n, dt in phases.items())
          + "; in the phases after the count "
          + ", ".join(f"{n} {c[0]} calls {c[1]:.3f} s"
                      for n, c in calls.items())
          + f"; KW {kw.launches} launches ({kw_seen} seen by the "
          f"profiler), {kw_ms:.4f} ms of device time"
          + (f"; KW launches by call site {dict(sites)}"
             if sites is not None else ""))
    shutil.rmtree(out, ignore_errors=True)
    if not record:
        return res, None
    kw_rec, k1_rec, k3_rec = recorders
    kw_calls = [(c if isinstance(kw_rec, cs.KWRecorder) else ("starts", c),
                 h) for c, h in kw_rec.calls]
    b_ms = sum(cs.kw_call_bound(c)[0] for c, _ in kw_calls)
    res["kw_bound_ms"] = b_ms
    print(f"ab {tag}: KW bound over its {len(kw_calls)} launches "
          f"{b_ms:.4f} ms against {kw_ms:.4f} ms of device time")
    return res, (kw_calls, k1_rec.calls, k3_rec.calls)


def asm_turns(work, dev, fq):
    """The asm with each side in turns: parent, current, current, parent.
    Returns the current side's recorded launches."""
    runs = {"parent": [], "current": []}
    recorded = None
    for i, side in enumerate(("parent", "current", "current", "parent")):
        pkg = PARENT if side == "parent" else "metamdbg_tpu_torch"
        res, calls = asm_run(work, dev, fq, pkg, f"{side}{i}", i < 2)
        runs[side].append(res)
        if side == "current" and calls is not None:
            recorded = calls
    for key in runs["current"][0]:
        if key == "kw_bound_ms":
            continue
        p, c = ([r[key] for r in runs[s]] for s in ("parent", "current"))
        print(f"ab asm {key}: parent {statistics.median(p):.4f} "
              f"({', '.join(f'{x:.4f}' for x in p)}), current "
              f"{statistics.median(c):.4f} "
              f"({', '.join(f'{x:.4f}' for x in c)})")
    for side in ("parent", "current"):
        r = runs[side][0]
        print(f"ab asm {side}: KW device time {r['kw_ms']:.4f} ms in "
              f"{r['kw_launches']} launches, bound {r['kw_bound_ms']:.4f} "
              f"ms ({r['kw_bound_ms'] / max(r['kw_ms'], 1e-9):.1%})")
    return recorded


def replay_phase(kw_calls, k1_calls, k3_calls, pk1, pkw, pk3, pk4):
    sums = [0.0, 0.0, 0.0]
    for i, ((codes, l, density, cap), _) in enumerate(k1_calls):
        for j, v in enumerate(k1_ab(f"main-path launch {i}", pk1, codes, l,
                                    density, cap)):
            sums[j] += v[0] if j == 2 else v
    print("ab sketch_tiles " + _line(
        f"the asm's {len(k1_calls)} launches", sums[0], sums[1],
        (sums[2], "sum")))
    keep, share, _ = cs.kw_replay_set(kw_calls)
    sums = [0.0, 0.0, 0.0]
    for i in keep:
        (mode, args), _ = kw_calls[i]
        what = f"main-path launch {i}"
        res = (kw_segments_ab(what, pkw, *args) if mode == "segments"
               else kw_ab(what, pkw, *args))
        for j, v in enumerate(res):
            sums[j] += v[0] if j == 2 else v
    print("ab window_hash " + _line(
        f"{len(keep)} of the asm's {len(kw_calls)} launches ({share:.2%} of "
        f"window words)", sums[0], sums[1], (sums[2], "sum")))
    for i, (args, _) in enumerate(k3_calls):
        sizes = np.diff(args[4].cpu().numpy())
        what = (f"the asm's call {i} ({sizes.size} groups, {int(sizes.sum())} "
                f"anchors, longest {int(sizes.max())})")
        print("ab chain_contig " + _line(what, *k3_ab(what, pk3, args[:5],
                                                      args[5])))
    if os.path.exists(cs.CHAIN_DP_SAVED):
        saved = torch.load(cs.CHAIN_DP_SAVED)
        kin = [t.cuda() for t in saved["inputs"]]
        sizes = np.diff(saved["inputs"][4].numpy())
        what = (f"the ONT asm's call ({sizes.size} groups, {int(sizes.sum())} "
                f"anchors, longest {int(sizes.max())}, band {saved['band']})")
        print("ab chain_dp " + _line(what, *k4_ab(what, pk4, kin,
                                                  saved["band"])))
    else:
        print(f"ab chain_dp: no saved ONT asm call ({cs.CHAIN_DP_SAVED}); "
              f"run chip_smoke.py first")


def main():
    if len(sys.argv) != 2:
        sys.exit(__doc__)
    cs.device_phase()
    dev = torch.device("cuda", 0)
    work = tempfile.mkdtemp(prefix="kernel_ab_")
    job = cs.reads_start(work, "hifi")
    try:
        parent = load_parent(sys.argv[1])
        sys.meta_path.insert(0, cs._RefuseJaxPackage())
        with concurrent.futures.ThreadPoolExecutor(4) as pool:
            parent_builds = [pool.submit(m._lib) for m in parent]
            cs.build_phase()
            for b in parent_builds:
                b.result()
        print(f"ab: the parent's sketch, window_hash, chain_contig and "
              f"chain_dp kernels built from {sys.argv[1]}")
        synthetic_phase(dev, *parent)
        fq = cs.reads_wait(job, "ab")
        replay_phase(*asm_turns(work, dev, fq), *parent)
    finally:
        if job[1].poll() is None:
            job[1].kill()
            job[1].wait()
        shutil.rmtree(work, ignore_errors=True)


if __name__ == "__main__":
    main()
