"""The port end to end, against the JAX package on the same reads.

The port runs in a subprocess whose `jax`, `jaxlib` and `metamdbg_tpu`
(the JAX package) imports are refused (a sys.meta_path finder installed by
a `-c` launcher), as on the machine with the GPU, which has no JAX. The
launcher also makes `os.fork` raise: the port forks nothing. Contigs must
be byte-identical to the JAX package's own run, for HiFi and for ONT: the
decompressed FASTA, and the gzip stream apart from its header's write time.
"""

import gzip
import json
import os
import shutil
import socket
import subprocess
import sys

import pytest

sys.path.insert(0, os.path.dirname(__file__))

import datagen
from metamdbg_tpu.__main__ import main as jax_main

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# argv[1]: the top-level packages to refuse, comma-separated
_BLOCKED_LAUNCHER = """
import importlib.abc, os, sys
BLOCKED = tuple(sys.argv.pop(1).split(","))
class _Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(name + " is blocked in this process")
        return None
sys.meta_path.insert(0, _Block())
def _no_fork():
    raise RuntimeError("the port forked")
os.fork = _no_fork
from metamdbg_tpu_torch.__main__ import main
sys.exit(main(sys.argv[1:]))
"""
JAX_AND_PACKAGE = ("jax", "jaxlib", "metamdbg_tpu")
# the ONT asm's read selection and correction artifacts
ONT_ARTIFACTS = ("read_data_init.txt", "read_stats.txt",
                 "repetitiveMinimizers.bin", "readAlignmentsLowDensity.bin",
                 "read_data_corrected.txt")


def run_port(args, timeout=300, blocked=JAX_AND_PACKAGE, env=None):
    env = dict(os.environ, PYTHONPATH=REPO, **(env or {}))
    return subprocess.run([sys.executable, "-c", _BLOCKED_LAUNCHER,
                           ",".join(blocked), *args],
                          cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=timeout)


def run_port_ranks(args_of_rank, world, timeout=300, env=None):
    """`run_port` as `world` ranks of one group over gloo on localhost,
    all started together; rank r runs args_of_rank(r). Each rank gets one
    torch thread, as torchrun gives each of several ranks on a host.
    Returns the finished processes' (returncode, stderr)."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = []
    for rank in range(world):
        renv = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1",
                    METAMDBG_TPU_DISTRIBUTED="1",
                    METAMDBG_TPU_COORDINATOR=f"127.0.0.1:{port}",
                    METAMDBG_TPU_NUM_PROCESSES=str(world),
                    METAMDBG_TPU_PROCESS_ID=str(rank), **(env or {}))
        procs.append(subprocess.Popen(
            [sys.executable, "-c", _BLOCKED_LAUNCHER,
             ",".join(JAX_AND_PACKAGE), *args_of_rank(rank)], cwd=REPO,
            env=renv, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
            text=True))
    try:
        errs = [p.communicate(timeout=timeout)[1] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return [(p.returncode, err) for p, err in zip(procs, errs)]


def read_device_json(out):
    with open(os.path.join(out, "tmp", "device.json")) as f:
        return json.load(f)


def assert_same_contigs(a: str, b: str):
    ra, rb = open(a, "rb").read(), open(b, "rb").read()
    assert gzip.decompress(ra) == gzip.decompress(rb)
    # bytes 4-7 of a gzip header hold the write time
    assert ra[:4] + ra[8:] == rb[:4] + rb[8:]


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """The JAX package's own asm on the tests/test_e2e.py:34 input, with
    its tmp kept so that the port can resume from it."""
    d = tmp_path_factory.mktemp("e2e")
    fq = str(d / "reads.fastq.gz")
    datagen.make_test_fastq(fq, genome_len=80_000, coverage=20,
                            mean_length=8000, error_rate=0.002, seed=9)
    out = str(d / "jax")
    os.environ["METAMDBG_TPU_KEEP_TMP"] = "1"
    try:
        jax_main(["asm", "--out-dir", out, "--in-hifi", fq])
    finally:
        os.environ.pop("METAMDBG_TPU_KEEP_TMP", None)
    return fq, out


@pytest.fixture(scope="module")
def jax_ont_run(tmp_path_factory):
    """The JAX package's own ONT asm (read correction included) on the
    tests/test_e2e.py:55-62 input, a 70 kb genome at 35x, on its host
    path (METAMDBG_TPU_HOST_ONLY, as chip_smoke.py's references run it):
    its XLA routes give the same bytes (tests/test_torch_correction.py
    compares the port with them) but take twice as long to compile here."""
    d = tmp_path_factory.mktemp("e2e_ont")
    fq = str(d / "reads.fastq.gz")
    genome = datagen.random_genome(70_000, seed=31)
    datagen.write_fastq(fq, datagen.sample_reads(
        genome, coverage=35, mean_length=8000, error_rate=0.005,
        ins_rate=0.0035, del_rate=0.0035, seed=32, mean_quality=22))
    out = str(d / "jax")
    env = {"METAMDBG_TPU_KEEP_TMP": "1", "METAMDBG_TPU_HOST_ONLY": "1"}
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        jax_main(["asm", "--out-dir", out, "--in-ont", fq])
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return fq, out


def test_port_asm_matches_jax_package(jax_run, tmp_path):
    """(a) A fresh port run with jax and the JAX package refused gives the
    JAX package's contigs: every stage, from read selection to toBasespace,
    ran in the port."""
    fq, jout = jax_run
    out = str(tmp_path / "port")
    proc = run_port(["asm", "--out-dir", out, "--in-hifi", fq,
                     "--device", "cpu"])
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert_same_contigs(os.path.join(jout, "contigs.fasta.gz"),
                        os.path.join(out, "contigs.fasta.gz"))
    for name in ("read_data_init.txt", "read_stats.txt"):
        assert open(os.path.join(jout, "tmp", name), "rb").read() == \
            open(os.path.join(out, "tmp", name), "rb").read(), name
    prov = read_device_json(out)
    assert prov["device"] == "cpu"
    stages = prov["stages"]
    for name in ("readSelection", "derepSmallContigs", "removeOverlaps",
                 "removeRepeats", "toBasespace"):
        assert stages[name] == "port:cpu", name
    graph_stages = [n for n in stages
                    if n.endswith(("_createGraph", "_generateContigs"))]
    assert len(graph_stages) > 20
    assert set(stages.values()) == {"port:cpu"}
    assert prov["sketch_kernel"]["tile_batches"] >= 1
    for kernel in ("sketch_kernel", "window_hash_kernel", "chain_kernel",
                   "chain_dp_kernel"):
        # the plain versions run on the CPU: no kernel launched
        assert prov[kernel]["launches"] == 0, kernel
        assert prov[kernel]["by_stage"] == {}, kernel


def test_port_ont_asm_matches_jax_package(jax_ont_run, tmp_path):
    """(a') ONT: the port's asm, read correction included, with jax and the
    JAX package refused and `os.fork` raising, gives the JAX package's
    contigs; its read selection and correction artifacts are the JAX
    package's byte for byte (tests/test_torch_correction.py holds the
    checksums), and every stage ran in the port."""
    fq, jout = jax_ont_run
    out = str(tmp_path / "port")
    proc = run_port(["asm", "--out-dir", out, "--in-ont", fq,
                     "--device", "cpu", "--threads", "1"],
                    env={"METAMDBG_TPU_KEEP_TMP": "1"})
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert_same_contigs(os.path.join(jout, "contigs.fasta.gz"),
                        os.path.join(out, "contigs.fasta.gz"))
    for name in ONT_ARTIFACTS:
        a = open(os.path.join(jout, "tmp", name), "rb").read()
        assert len(a) > 0 and a == \
            open(os.path.join(out, "tmp", name), "rb").read(), name
    prov = read_device_json(out)
    assert prov["stages"]["readCorrection"] == "port:cpu"
    assert set(prov["stages"].values()) == {"port:cpu"}
    # one rank: no group, nothing sharded
    assert prov["distributed"] == {"rank": 0, "world_size": 1,
                                   "transport": None, "sharded": {}}


def test_two_rank_ont_asm_matches_jax_package(jax_ont_run, tmp_path):
    """(a'') The slice as a whole: the port's ONT asm as two ranks over
    gloo, each with its own out dir, jax and the JAX package refused and
    `os.fork` raising. Every rank ran the pair joins, the first pass's
    count and the window POAs sharded, and wrote the JAX package's
    artifacts and contigs."""
    fq, jout = jax_ont_run
    outs = [str(tmp_path / f"rank{r}") for r in range(2)]
    done = run_port_ranks(
        lambda r: ["asm", "--out-dir", outs[r], "--in-ont", fq, "--device",
                   "cpu", "--threads", "1"], 2,
        env={"METAMDBG_TPU_KEEP_TMP": "1"})
    for rc, err in done:
        assert rc == 0, err[-4000:]
    for rank, out in enumerate(outs):
        assert_same_contigs(os.path.join(jout, "contigs.fasta.gz"),
                            os.path.join(out, "contigs.fasta.gz"))
        for name in ONT_ARTIFACTS:
            a = open(os.path.join(jout, "tmp", name), "rb").read()
            assert len(a) > 0 and a == \
                open(os.path.join(out, "tmp", name), "rb").read(), name
        prov = read_device_json(out)
        assert set(prov["stages"].values()) == {"port:cpu"}
        dist = prov["distributed"]
        assert (dist["rank"], dist["world_size"], dist["transport"]) == \
            (rank, 2, "gloo")
        sharded = dist["sharded"]
        assert set(sharded) == {"readCorrection", "k4_createGraph",
                                "toBasespace"}
        assert sharded["readCorrection"]["pair_join"]["calls"] >= 1
        assert sharded["k4_createGraph"]["count_table"]["calls"] == 1
        assert sharded["toBasespace"]["polish"]["calls"] >= 2


def test_port_resumes_jax_package_run(jax_run, tmp_path):
    """(b) A run written by the JAX package, its final checkpoint removed,
    is resumed by the port to the same contigs: the on-disk state is
    shared."""
    fq, jout = jax_run
    out = str(tmp_path / "resumed")
    shutil.copytree(jout, out)
    os.remove(os.path.join(out, "contigs.fasta.gz"))
    os.remove(os.path.join(out, "tmp", "checkpoints",
                           "toBasespace.checkpoint"))
    proc = run_port(["asm", "--out-dir", out, "--in-hifi", fq,
                     "--device", "cpu"])
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert_same_contigs(os.path.join(jout, "contigs.fasta.gz"),
                        os.path.join(out, "contigs.fasta.gz"))
    track = open(os.path.join(out, "tmp", "memoryTrack.txt")).read()
    # only toBasespace ran again
    assert track.count("toBasespace") == 2
    assert track.count("readSelection") == 1


def test_port_resumes_mid_ladder(jax_run, tmp_path, monkeypatch):
    """(b2) A JAX-package run cut at the start of pass k=8 (every
    checkpoint from k8_createGraph on is missing) is resumed by the port,
    which runs the rest of the ladder itself, to the same contigs."""
    from metamdbg_tpu.graph import multiplex as jmultiplex

    fq, jout = jax_run
    out = str(tmp_path / "cut")
    real = jmultiplex.run_graph_multiplex_pass

    class Cut(Exception):
        pass

    def cut_at_k8(tmp_dir, k, params):
        if k == 8:
            raise Cut("cut at k8_createGraph")
        return real(tmp_dir, k, params)

    monkeypatch.setattr(jmultiplex, "run_graph_multiplex_pass", cut_at_k8)
    monkeypatch.setenv("METAMDBG_TPU_KEEP_TMP", "1")
    with pytest.raises(Cut):
        jax_main(["asm", "--out-dir", out, "--in-hifi", fq])
    ckpts = os.listdir(os.path.join(out, "tmp", "checkpoints"))
    assert "k7_toMinspaceContigs.checkpoint" in ckpts
    assert not any(c.startswith("k8_") for c in ckpts)

    proc = run_port(["asm", "--out-dir", out, "--in-hifi", fq,
                     "--device", "cpu"])
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert_same_contigs(os.path.join(jout, "contigs.fasta.gz"),
                        os.path.join(out, "contigs.fasta.gz"))
    track = open(os.path.join(out, "tmp", "memoryTrack.txt")).read()
    assert track.count("k7_createGraph") == 1
    assert track.count("k8_createGraph") == 1


@pytest.mark.parametrize("command", ["asm", "gfa", "map"])
def test_device_cuda_without_gpu_fails(tmp_path, command):
    """(c) --device cuda on a box with no GPU exits non-zero, clearly, at
    startup: `asm` writes no read data, and `gfa` and `map` fail before
    they look at their output directory (here one that does not exist)."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("this box has a GPU")
    out = str(tmp_path / "out")
    if command == "asm":
        fq = str(tmp_path / "reads.fastq.gz")
        datagen.make_test_fastq(fq, genome_len=5000, coverage=2,
                                mean_length=2000, seed=3)
        args = ["asm", "--out-dir", out, "--in-hifi", fq]
    elif command == "gfa":
        args = ["gfa", out, "5", "--coverage"]
    else:
        args = ["map", out, "5", "--references", str(tmp_path / "g.fa")]
    proc = run_port([*args, "--device", "cuda"], timeout=120)
    assert proc.returncode != 0
    assert "torch.cuda.is_available() is False" in proc.stderr
    assert not os.path.exists(os.path.join(out, "tmp",
                                           "read_data_init.txt"))


@pytest.mark.parametrize("platform", ["hifi", "ont"])
def test_threads_above_one(request, tmp_path, platform):
    """ROADMAP Queue 3 (fork after OpenMP hung toBasespace at --threads >
    1). At --threads 4 the port runs through toBasespace, ONT read
    correction included, with torch's thread pool and the native
    libraries' OpenMP pools started in its process and `os.fork` refused,
    within the timeout, to the contigs of the JAX package's --threads 1
    run (which tests (a) and (a') hold the port's --threads 1 runs to)."""
    fq, jout = request.getfixturevalue(
        "jax_run" if platform == "hifi" else "jax_ont_run")
    out = str(tmp_path / "out")
    proc = run_port(["asm", "--out-dir", out, f"--in-{platform}", fq,
                     "--device", "cpu", "--threads", "4"], timeout=240)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert_same_contigs(os.path.join(jout, "contigs.fasta.gz"),
                        os.path.join(out, "contigs.fasta.gz"))
    stages = read_device_json(out)["stages"]
    assert stages["toBasespace"] == "port:cpu"
    assert stages.get("readCorrection", "port:cpu") == "port:cpu"
    assert ("readCorrection" in stages) == (platform == "ont")


def test_port_modules_import_no_jax_package():
    """Every module of the port imports with the JAX package (and jax)
    refused, and none of them loads it."""
    import pkgutil

    import metamdbg_tpu_torch

    names = sorted(m.name for m in pkgutil.walk_packages(
        metamdbg_tpu_torch.__path__, "metamdbg_tpu_torch."))
    assert "metamdbg_tpu_torch.kernels.chain_dp" in names
    assert "metamdbg_tpu_torch.correction.stage" in names
    for name in ("pipeline.gfa", "pipeline.mapref", "io.gfa",
                 "parallel", "parallel.multihost", "parallel.count_table",
                 "parallel.pair_join", "parallel.polish_mesh"):
        assert "metamdbg_tpu_torch." + name in names
    assert "metamdbg_tpu_torch.bridge" not in names
    script = (
        "import importlib, importlib.abc, sys\n"
        "class _Block(importlib.abc.MetaPathFinder):\n"
        "    def find_spec(self, name, path, target=None):\n"
        "        if name.split('.')[0] in ('metamdbg_tpu', 'jax', 'jaxlib'):\n"
        "            raise ImportError(name + ' is blocked')\n"
        "sys.meta_path.insert(0, _Block())\n"
        "for name in sys.argv[1:]:\n"
        "    importlib.import_module(name)\n"
        "print(sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('metamdbg_tpu', 'jax')))\n")
    proc = subprocess.run([sys.executable, "-c", script, *names], cwd=REPO,
                          env=dict(os.environ, PYTHONPATH=REPO),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert proc.stdout.strip() == "[]"

