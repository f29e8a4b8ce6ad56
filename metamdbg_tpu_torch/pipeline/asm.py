"""`asm` pipeline orchestrator (HiFi and ONT paths).

The port of metamdbg_tpu/pipeline/asm.py, itself after AssemblyPipeline
(src/pipeline/AssemblyPipeline.hpp:87-1016): one process, stage checkpoints
as marker files, parameters.gz per pass, pass_k snapshots for the gfa
subcommand, tmp cleanup at the end. The on-disk state is the JAX
package's, so a run of either package resumes the other's.

Every stage runs in the port, on `device`, with the native host
libraries on `n_threads` Python threads, one pool per stage
(utils/threadmap.py); nothing forks: read selection, ONT read
correction, the minimizer-space ladder (first pass, second pass, every
multiplex pass, contigs and toMinspace), post-processing (derep, overlaps,
repeats) and toBasespace.
Observability: `metaMDBG.log` next to the output, per-stage wall-clock and
the process's own peak RSS (`peak_rss_gb`) in tmp/memoryTrack.txt and
tmp/perf.txt, and tmp/device.json, rewritten after every stage: the
device, the route of each stage ("port:<device>"), and for each kernel
(sketch, window hash, chain, chain DP) its launches in all and per stage
(a stage that launched a kernel no time has no entry for it), and K2's
row counts on the card likewise; the sketch kernel's also counts its
overflow relaunches and the tile batches; and the group of ranks: rank,
world size, transport, and for each stage that ran sharded what each
sharded function did there (parallel/__init__.py's counters). The run,
each stage and the steps inside are spans (utils/spans.py): the stage
walls above and the timing lines of the log read them, and under
`torch.profiler` or `asm --trace-out` they keep records.

Run as N ranks (METAMDBG_TPU_DISTRIBUTED and the variables of
parallel/__init__.py, an --out-dir per rank), `run` starts the group
first; readCorrection's pair joins (K6), the first pass's count (K5) and
toBasespace's window POAs then run sharded, and every rank writes the
one-rank run's files.
"""

import contextlib
import gzip
import json
import logging
import os
import shutil
import threading
import time

import numpy as np
import torch

from .. import parallel
from ..basespace import postprocess, reconstruct
from ..constants import compute_last_k
from ..correction import stage as correction
from ..graph import contigs, multiplex, stage
from ..io import native, records
from ..kernels import chain as kchain
from ..kernels import chain_dp as kchain_dp
from ..kernels import count as kcount
from ..kernels import sketch as ksketch
from ..kernels import window_hash
from ..sketch import batch, read_selection
from ..utils import spans, threadmap
from ..utils.spans import status_kb as _status_kb
from . import open_device

log = logging.getLogger("metamdbg_tpu_torch")


# where /proc/self/status has no VmHWM: the highest VmRSS read so far
_rss_peak_kb = [0]
_rss_lock = threading.Lock()
_rss_sampler: list = []


def _note_rss() -> int:
    kb = _status_kb("VmRSS") or 0
    with _rss_lock:
        _rss_peak_kb[0] = max(_rss_peak_kb[0], kb)
        return _rss_peak_kb[0]


def start_rss_sampler(interval_s: float = 0.05):
    """Where /proc/self/status has no VmHWM (gVisor's has none), read
    VmRSS every `interval_s` on a daemon thread for the life of the
    process, so that peak_rss_gb sees the peaks between its calls."""
    if _rss_sampler or _status_kb("VmHWM") is not None:
        return

    def sample():
        while True:
            _note_rss()
            time.sleep(interval_s)

    thread = threading.Thread(target=sample, name="metamdbg_rss",
                              daemon=True)
    thread.start()
    _rss_sampler.append(thread)


def peak_rss_gb() -> float:
    """This process's own peak resident set: VmHWM, which starts afresh at
    exec, or where /proc has none the highest VmRSS sampled (getrusage's
    ru_maxrss does not start afresh: a child reads its parent's peak)."""
    kb = _status_kb("VmHWM")
    return (kb if kb is not None else _note_rss()) / 1024.0 / 1024.0


def attach_log_file(out_dir: str):
    """metaMDBG.log next to the output dir (src/utils/Logger.h:68-91)."""
    path = os.path.join(out_dir, "metaMDBG.log")
    root = logging.getLogger()
    for h in root.handlers:
        if isinstance(h, logging.FileHandler) and \
                getattr(h, "baseFilename", None) == os.path.abspath(path):
            return
    handler = logging.FileHandler(path, mode="a")
    handler.setFormatter(logging.Formatter(
        "%(asctime)s %(levelname)s %(message)s"))
    handler.setLevel(logging.DEBUG)
    root.addHandler(handler)


class Pipeline:

    def __init__(self, out_dir: str, read_paths, platform: str = "hifi",
                 device: str = "cuda",
                 min_read_quality: float = 0.0, max_k: int = 0,
                 min_abundance: int = 0, max_bubble_length: int = 50000,
                 max_tip_length: int = 50000, minimizer_size: int = 15,
                 density_assembly: float = 0.005,
                 density_correction: float = 0.025,
                 min_contig_length: int = 50, min_contig_coverage: float = 1.0,
                 skip_correction: bool = False,
                 all_assembly_graph: bool = False, n_threads: int = 1):
        self.device = open_device(device)
        start_rss_sampler()
        native.build_all()
        self.out_dir = out_dir
        self.tmp_dir = os.path.join(out_dir, "tmp")
        self.read_paths = [os.path.abspath(p) for p in read_paths]
        self.platform = platform
        self.min_read_quality = min_read_quality
        self.max_k = max_k
        self.min_abundance = min_abundance
        self.max_bubble_length = max_bubble_length
        self.max_tip_length = max_tip_length
        self.minimizer_size = min(minimizer_size, 16)
        self.density_assembly = density_assembly
        self.density_correction = density_correction
        self.min_contig_length = max(50, min_contig_length)
        self.min_contig_coverage = max(1.0, min_contig_coverage)
        self.all_assembly_graph = all_assembly_graph
        self.n_threads = max(1, n_threads)
        self.use_hpc = platform == "hifi"
        self.skip_correction = skip_correction or platform == "hifi"
        # platform presets (AssemblyPipeline.hpp:292-325)
        self.read_correction_min_identity = 0.99 if platform == "hifi" else 0.96
        self.read_correction_min_overlap = 1000
        self.first_k = 4
        self.last_k = 0
        self.routes: dict = {}
        self.window_hash_launches: dict = {}
        self.sketch_launches: dict = {}
        self.chain_launches: dict = {}
        self.chain_dp_launches: dict = {}
        self.row_count_launches: dict = {}
        # the multiplex passes' phase spans' seconds, summed over the passes
        self.multiplex_phase_seconds: dict = {}
        self.sharded: dict = {}
        self.group = None
        self.reads_cache = multiplex.ReadsCache()

        for d in ("", "filter", "checkpoints", "smallContigs"):
            os.makedirs(os.path.join(self.tmp_dir, d), exist_ok=True)
        with open(os.path.join(self.tmp_dir, "input.txt"), "w") as f:
            for p in self.read_paths:
                f.write(p + "\n")
        attach_log_file(out_dir)

    # -- perf accounting and provenance (src/Commons.hpp:2918-2938) ---------
    @contextlib.contextmanager
    def _stage(self, name: str):
        """The stage in a span `stage.<name>`, which carries its kernel
        launches as counts."""
        route = f"port:{self.device.type}"
        kernels = (("sketch", self.sketch_launches, ksketch),
                   ("window_hash", self.window_hash_launches, window_hash),
                   ("chain", self.chain_launches, kchain),
                   ("chain_dp", self.chain_dp_launches, kchain_dp),
                   ("row_count", self.row_count_launches, kcount))
        before = [k.launches for _, _, k in kernels]
        before_sharded = {n: dict(c) for n, c in parallel.activity.items()}
        with spans.span("stage." + name, rss=True) as s:
            with threadmap.stage_pool(self.n_threads):
                yield
            for (label, counts, k), n0 in zip(kernels, before):
                if k.launches > n0:
                    counts[name] = k.launches - n0
                    s.add("launches." + label, k.launches - n0)
        dt = s.seconds
        for key, seconds in s.counts.items():
            if key.startswith("multiplex."):
                phase = key[len("multiplex."):]
                self.multiplex_phase_seconds[phase] = \
                    self.multiplex_phase_seconds.get(phase, 0) + seconds
        for fn, after in parallel.activity.items():
            prev = before_sharded.get(fn, {})
            if after["calls"] > prev.get("calls", 0):
                self.sharded.setdefault(name, {})[fn] = {
                    key: v - prev.get(key, 0) for key, v in after.items()}
        rss = peak_rss_gb()
        with open(os.path.join(self.tmp_dir, "memoryTrack.txt"), "a") as f:
            f.write(f"{name}\t{dt:.2f}s\t{rss:.3f}GB\n")
        with open(os.path.join(self.tmp_dir, "perf.txt"), "w") as f:
            f.write(f"{rss:.3f}\n")
        self.routes[name] = route
        self._dump_device_json()
        log.debug("stage %s (%s): %.2fs, peak RSS %.3f GB", name, route, dt,
                  rss)

    def _dump_device_json(self):
        if self.device.type == "cuda":
            name = torch.cuda.get_device_name(self.device)
        else:
            name = "cpu"
        doc = {"device": name, "stages": self.routes,
               "sketch_kernel": {
                   "launches": ksketch.launches,
                   "overflow_relaunches": ksketch.overflow_launches,
                   "tile_batches": batch.tile_batches,
                   "by_stage": self.sketch_launches},
               "window_hash_kernel": {
                   "launches": window_hash.launches,
                   "by_stage": self.window_hash_launches,
                   "by_site": dict(sorted(window_hash.sites.items()))},
               "multiplex_phase_seconds": self.multiplex_phase_seconds,
               "chain_kernel": {
                   "launches": kchain.launches,
                   "by_stage": self.chain_launches},
               "chain_dp_kernel": {
                   "launches": kchain_dp.launches,
                   "by_stage": self.chain_dp_launches},
               "row_count_k2": {
                   "launches": kcount.launches,
                   "by_stage": self.row_count_launches},
               "distributed": {**parallel.describe(),
                               "sharded": self.sharded}}
        with open(os.path.join(self.tmp_dir, "device.json"), "w") as f:
            json.dump(doc, f, indent=1)

    # -- checkpoints --------------------------------------------------------
    def _ckpt(self, name):
        return os.path.join(self.tmp_dir, "checkpoints", name + ".checkpoint")

    def _done(self, name):
        return os.path.exists(self._ckpt(name))

    def _mark(self, name):
        open(self._ckpt(name), "w").close()

    # -- parameters ---------------------------------------------------------
    def make_params(self, k: int, prev_k: int) -> records.Parameters:
        spacing = 1 / np.float32(self.density_assembly)
        return records.Parameters(
            minimizer_size=self.minimizer_size, kminmer_size=k,
            density_assembly=self.density_assembly,
            kminmer_size_first=self.first_k,
            minimizer_spacing_mean=float(spacing),
            kminmer_length_mean=float(spacing * np.float32(k - 1)),
            kminmer_overlap_mean=float(spacing * np.float32(k - 1)
                                       - spacing),
            kminmer_size_prev=prev_k, kminmer_size_last=self.last_k,
            mean_read_length=self.mean_read_length,
            density_correction=self.density_correction,
            use_homopolymer_compression=self.use_hpc,
            data_type=0 if self.platform == "hifi" else 1,
            snpmer_size=21)

    # -- stages -------------------------------------------------------------
    def run(self):
        """The whole asm, in a root span `asm`."""
        with spans.span("asm") as total:
            self._run()
        self._log_final_summary(total.seconds)

    def _run(self):
        # ranks find each other before anything else (as the JAX package's
        # devwarm.start_warmup -> parallel.ensure_distributed)
        self.device = parallel.ensure_distributed(self.device)
        self.group = parallel.production_group()
        self.mean_read_length = 0
        params = self.make_params(self.first_k, self.first_k)
        params.save(os.path.join(self.tmp_dir, "parameters.gz"))

        log.info("Converting reads to minimizers")
        if not self._done("convertReadsToMinimizerSpace"):
            with self._stage("readSelection"):
                read_selection.run_read_selection(
                    self.read_paths, self.tmp_dir, params, self.device,
                    min_read_quality=self.min_read_quality,
                    skip_correction=self.skip_correction)
            self._mark("convertReadsToMinimizerSpace")

        stats = records.ReadStats.load(os.path.join(self.tmp_dir,
                                                    "read_stats.txt"))
        self.mean_read_length = stats.n50
        self.last_k = compute_last_k(self.density_assembly, stats.n50,
                                     self.first_k, self.max_k)
        log.info("Total read bp: %d | N50 read length: %d | k: %d..%d",
                 stats.nb_bases, stats.n50, self.first_k, self.last_k)

        if not self.skip_correction:
            log.info("Correcting reads")
            if not self._done("correctReads"):
                params = self.make_params(self.first_k, self.first_k)
                params.save(os.path.join(self.tmp_dir, "parameters.gz"))
                with self._stage("readCorrection"):
                    correction.run_read_correction(
                        self.tmp_dir, params, self.device,
                        self.read_correction_min_identity,
                        self.read_correction_min_overlap, self.n_threads,
                        group=self.group)
                self._mark("correctReads")

        prev_k = self.first_k
        pass_index = 0
        k = self.first_k
        self.next_gen_graph_k = 11  # AssemblyPipeline.hpp:496
        while True:
            is_final = k == self.last_k
            log.info("Multi-k pass: %d/%d", k, self.last_k)
            params = self.make_params(k, prev_k)
            params.save(os.path.join(self.tmp_dir, "parameters.gz"))

            if not self._done(f"k{k}_createGraph"):
                with self._stage(f"k{k}_createGraph"):
                    if pass_index == 0:
                        stage.run_graph_first_pass(self.tmp_dir, k,
                                                   self.min_abundance,
                                                   self.device,
                                                   group=self.group)
                    elif k == self.first_k + 1:
                        stage.run_graph_second_pass(self.tmp_dir, k, params,
                                                    self.device)
                    else:
                        multiplex.run_graph_multiplex_pass(
                            self.tmp_dir, k, params, self.device,
                            self.reads_cache)
                self._mark(f"k{k}_createGraph")

            # AssemblyPipeline.hpp:492,834: --all-assembly-graph forces a
            # graph snapshot at every pass
            gen_graph = pass_index > 0 and (self.all_assembly_graph
                                            or k == self.next_gen_graph_k)
            if not self._done(f"k{k}_generateContigs"):
                with self._stage(f"k{k}_generateContigs"):
                    contigs.run_contig_stage(self.tmp_dir, params,
                                             self.max_bubble_length,
                                             self.max_tip_length,
                                             gen_graph=gen_graph)
                self._mark(f"k{k}_generateContigs")

            if gen_graph and not self._done(f"k{k}_toMinspaceAssemblyGraph"):
                contigs.run_to_minspace(
                    self.tmp_dir,
                    os.path.join(self.tmp_dir,
                                 "assembly_graph.gfa.unitigs.nodepath"),
                    os.path.join(self.tmp_dir, "assembly_graph.gfa.unitigs"),
                    os.path.join(self.tmp_dir, "unitigGraph.nodes.bin"),
                    params)
                self._mark(f"k{k}_toMinspaceAssemblyGraph")
            if k == self.next_gen_graph_k:
                # AssemblyPipeline.hpp:1273-1280
                self.next_gen_graph_k += 1 if self.all_assembly_graph else 10

            out_name = "contig_data_init.txt" if is_final else "unitig_data.txt"
            if not self._done(f"k{k}_toMinspaceContigs"):
                contigs.run_to_minspace(
                    self.tmp_dir,
                    os.path.join(self.tmp_dir, "contigs.nodepath"),
                    os.path.join(self.tmp_dir, out_name),
                    os.path.join(self.tmp_dir, "unitigGraph.nodes.bin"),
                    params)
                self._mark(f"k{k}_toMinspaceContigs")

            self._save_pass_snapshot(k)

            if is_final:
                break
            prev_k = k
            pass_index += 1
            k += 1

        self._run_final_stages(params)
        if not os.environ.get("METAMDBG_TPU_KEEP_TMP"):
            self._clean_tmp_files()

    def _clean_tmp_files(self):
        """End-of-run tmp cleanup (cleanTmpAssemblyFiles + cleanTmpFiles,
        AssemblyPipeline.hpp:427-484,1120,388; skipped under
        METAMDBG_TPU_KEEP_TMP). read_data_init.txt, the pass_k snapshots,
        contig_data_final.bin and parameters survive — the gfa subcommand
        needs them."""
        names = [
            "kminmerData_abundance.txt", "kminmerData_min.txt",
            "kminmerData_abundance_prev.txt",
            "unitigGraph.nodes.refined_abundances.bin", "unitig_data.txt",
            "contigs.nodepath", "assembly_graph.gfa.unitigs.nodepath",
            "unitigGraph.nodes.bin", "unitigGraph.nodes.abundances.bin",
            "unitigGraph.edges.successors.bin", "unitigGraph.stats.bin",
            "unitigGraph_prev.nodes.bin",
            "unitigGraph_prev.nodes.abundances.bin",
            "unitigGraph_prev.edges.successors.bin",
            "unitigGraph_prev.stats.bin", "read_data_corrected.txt",
            "contig_data_init.txt", "contig_data_init_small.txt",
            "contig_data_init_small.txt.nooverlaps",
            "contig_data_init_small.txt.norepeats",
            "readsVsContigsAlignments.bin",
        ]
        for name in names:
            path = os.path.join(self.tmp_dir, name)
            if os.path.exists(path):
                os.remove(path)
        for dirname in ("filter", "_polish_readPartitions"):
            shutil.rmtree(os.path.join(self.tmp_dir, dirname),
                          ignore_errors=True)

    def _save_pass_snapshot(self, k: int):
        """pass_k<k>/ snapshot for the gfa subcommand — exactly what
        savePassData retains (AssemblyPipeline.hpp:1436-1465): parameters.gz
        plus assembly_graph.gfa{,.unitigs} when this pass generated them;
        first pass skipped, existing dirs left untouched on resume."""
        if k == self.first_k:
            return
        d = os.path.join(self.tmp_dir, f"pass_k{k}")
        if os.path.isdir(d):
            return
        os.makedirs(d, exist_ok=True)
        shutil.copyfile(os.path.join(self.tmp_dir, "parameters.gz"),
                        os.path.join(d, "parameters.gz"))
        for name in ("assembly_graph.gfa", "assembly_graph.gfa.unitigs"):
            src = os.path.join(self.tmp_dir, name)
            if os.path.exists(src):
                shutil.move(src, os.path.join(d, name))
        src = os.path.join(self.tmp_dir, "assembly_graph.gfa.unitigs.nodepath")
        if os.path.exists(src):
            os.remove(src)

    def _run_final_stages(self, params):
        log.info("Derep small contigs")
        if not self._done("derepSmallContigs"):
            with self._stage("derepSmallContigs"):
                postprocess.run_derep_small(self.tmp_dir, params,
                                            self.first_k, self.last_k)
            self._mark("derepSmallContigs")

        log.info("Removing overlaps and duplication")
        if not self._done("removeOverlaps"):
            with self._stage("removeOverlaps"):
                postprocess.run_remove_overlaps(self.tmp_dir, params,
                                                self.device)
            self._mark("removeOverlaps")

        if not self._done("removeRepeats"):
            with self._stage("removeRepeats"):
                postprocess.run_remove_repeats(self.tmp_dir, params,
                                               self.device)
            self._mark("removeRepeats")

        log.info("Constructing base-space contigs")
        if not self._done("toBasespace"):
            with self._stage("toBasespace"):
                reconstruct.run_to_basespace(
                    self.tmp_dir, self.read_paths,
                    os.path.join(self.out_dir, "contigs.fasta.gz"), params,
                    self.device, self.min_contig_length,
                    self.min_contig_coverage, self.n_threads,
                    group=self.group)
            self._mark("toBasespace")

    def _log_final_summary(self, run_seconds: float):
        """Final stats block (AssemblyPipeline.hpp:383-404,1685-1726)."""
        contig_path = os.path.join(self.out_dir, "contigs.fasta.gz")
        lengths = []
        circular_over_1m = 0
        with gzip.open(contig_path, "rb") as f:
            length = 0
            circular = False
            for line in f:
                if line.startswith(b">"):
                    if length:
                        lengths.append(length)
                        if circular and length > 1_000_000:
                            circular_over_1m += 1
                    length = 0
                    circular = b"circular=yes" in line
                else:
                    length += len(line.strip())
            if length:
                lengths.append(length)
                if circular and length > 1_000_000:
                    circular_over_1m += 1
        total = sum(lengths)
        n50 = 0
        acc = 0
        for ln in sorted(lengths, reverse=True):
            acc += ln
            if acc * 2 >= total:
                n50 = ln
                break
        log.info("Run time: %.0f s", run_seconds)
        log.info("Peak memory: %.3f GB", peak_rss_gb())
        log.info("Assembly length: %d", total)
        log.info("Contigs N50: %d", n50)
        log.info("Nb contigs: %d", len(lengths))
        log.info("Nb circular contigs (>1Mb): %d", circular_over_1m)
        log.info("Contig filename: %s", contig_path)
        log.info("Done!")
