"""Time a parent commit's K1, KW, K3 and K4 beside the current ones on one
NVIDIA GPU, and the device's idle share over the HiFi asm.

Run from the root of a checkout, with the parent commit's package unpacked
into a directory that .gitignore lists:

    mkdir -p chip_checkout/parent
    git archive HEAD~1 metamdbg_tpu_torch | tar -x -C chip_checkout/parent
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
versions.

1. K1 on chip_smoke.py phase 3's (512, 16384) tiles at the main path's
   three densities;
2. KW on phase 3b's stream of 4,194,304 minimizers, dense at w = 16, 61
   and 123, shuffled at w = 16, and on (2^20, 24) row slices at w = 23;
3. K3 on phase 3d's groups and K4 on phase 3e's at band 62;
4. the HiFi asm of phase 4 (`asm --device cuda --threads 1`, the JAX
   package refused) under torch.profiler, every K1 and KW launch and the
   K3 call recorded as chip_smoke.py records them: the stage walls, the
   device's busy time and idle share, the largest device-time entries and
   each kernel's device time in its launches;
5. the asm's own launches again: every K1 launch and the KW launches of
   chip_smoke.kw_replay_set, with the sums of both sides' times and of the
   bounds, and the K3 call; the host clock per hash_windows call of both
   wrappers on the 20 smallest KW launches; and the ONT asm's K4 call where
   chip_smoke.py phase 8 saved it in this checkout (chip_inputs/, so run
   chip_smoke.py first in the same call).
"""

import concurrent.futures
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


def profile_summary(prof, wall):
    """Device time in all and by kernel from a torch.profiler run, and the
    idle share of the wall."""
    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0))

    events = sorted(prof.key_averages(), key=dev_us, reverse=True)
    busy_s = sum(dev_us(e) for e in events) / 1e6
    print(f"ab profile: device busy {busy_s:.4f} s of a {wall:.1f} s wall, "
          f"idle {1 - busy_s / wall:.4%}")
    for e in events[:8]:
        print(f"ab profile: {dev_us(e) / 1e3:.2f} ms, {e.count} calls: "
              f"{e.key[:90]}")
    for name in ("sketch_tiles_kernel", "window_hash_kernel",
                 "chain_contig_kernel", "chain_dp_kernel"):
        own = [e for e in events if name in e.key]
        print(f"ab profile: {name}: "
              f"{sum(dev_us(e) for e in own) / 1e3:.4f} ms of device time "
              f"in {sum(e.count for e in own)} launches")


def asm_phase(work, dev, fq):
    """The HiFi asm under torch.profiler; returns the recorded (KW, K1,
    K3) launches."""
    from metamdbg_tpu_torch.__main__ import main
    from metamdbg_tpu_torch.kernels import chain as kchain
    from metamdbg_tpu_torch.kernels import sketch as ksketch
    from metamdbg_tpu_torch.kernels import window_hash as kw

    out = os.path.join(work, "port")
    os.environ["METAMDBG_TPU_KEEP_TMP"] = "1"
    prof = torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CUDA])
    with cs.LaunchRecorder(kw) as kw_rec, cs.LaunchRecorder(ksketch) as \
            k1_rec, cs.LaunchRecorder(kchain) as k3_rec:
        prof.start()
        t0 = time.perf_counter()
        rc = main(["asm", "--out-dir", out, "--in-hifi", fq, "--device",
                   dev.type, "--threads", "1"])
        wall = time.perf_counter() - t0
        prof.stop()
    if rc != 0:
        cs.fail(f"asm returned {rc}")
    walls, rss = cs._stage_walls(out)
    for name, dt in walls.items():
        print(f"ab asm stage {name}: {dt:.2f} s")
    print(f"ab asm: wall {wall:.1f} s under torch.profiler, peak RSS {rss}; "
          f"{len(kw_rec.calls)} KW, {len(k1_rec.calls)} K1 and "
          f"{len(k3_rec.calls)} K3 launches")
    profile_summary(prof, wall)
    return kw_rec.calls, k1_rec.calls, k3_rec.calls


def replay_phase(kw_calls, k1_calls, k3_calls, pk1, pkw, pk3, pk4):
    from metamdbg_tpu_torch.kernels import window_hash as kw

    sums = [0.0, 0.0, 0.0]
    for i, ((codes, l, density, cap), _) in enumerate(k1_calls):
        for j, v in enumerate(k1_ab(f"main-path launch {i}", pk1, codes, l,
                                    density, cap)):
            sums[j] += v[0] if j == 2 else v
    print("ab sketch_tiles " + _line(
        f"the asm's {len(k1_calls)} launches", sums[0], sums[1],
        (sums[2], "sum")))
    keep, share, info = cs.kw_replay_set(kw_calls)
    sums = [0.0, 0.0, 0.0]
    for i in keep:
        cat, starts, w, normalize = kw_calls[i][0]
        for j, v in enumerate(kw_ab(f"main-path launch {i}", pkw, cat,
                                    starts, w, normalize)):
            sums[j] += v[0] if j == 2 else v
    print("ab window_hash " + _line(
        f"{len(keep)} of the asm's {len(kw_calls)} launches ({share:.2%} of "
        f"window words)", sums[0], sums[1], (sums[2], "sum")))
    small = [i for i in range(len(kw_calls)) if info[i][0] < cs.KW_BINS[2]]
    host = {"parent": [], "current": []}
    for i in small[:20]:
        cat, starts, w, normalize = kw_calls[i][0]
        for side, mod in (("parent", pkw), ("current", kw), ("current", kw),
                          ("parent", pkw)):
            host[side].append(cs._host_ms(
                lambda: mod.hash_windows(cat, starts, w, normalize)))
    print(f"ab window_hash host clock per hash_windows call on the "
          f"{len(small[:20])} smallest launches (< {cs.KW_BINS[2]} windows): "
          f"parent {statistics.mean(host['parent']):.4f} ms, current "
          f"{statistics.mean(host['current']):.4f} ms")
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
        replay_phase(*asm_phase(work, dev, fq), *parent)
    finally:
        if job[1].poll() is None:
            job[1].kill()
            job[1].wait()
        shutil.rmtree(work, ignore_errors=True)


if __name__ == "__main__":
    main()
