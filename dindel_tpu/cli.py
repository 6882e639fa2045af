"""Command-line interface.

``python -m dindel_tpu --analysis {getCIGARindels,indels,realignCandidates}``
mirrors the reference binary's options (DInDel.cpp:4074-4308); additional
subcommands cover the reference's Python pipeline scripts:

  --analysis makeWindows      (python/makeWindows.py)
  --analysis selectCandidates (python/selectCandidates.py)
  --analysis mergeOutputDiploid (python/mergeOutputDiploid.py)
  --analysis mergeOutputPooled  (python/mergeOutputPooled.py)
"""

from __future__ import annotations

import argparse
import sys

from .config import Parameters
from .model import LibraryCollection


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="dindel_tpu")
    ap.add_argument("--analysis", default="indels")
    ap.add_argument("--ref")
    ap.add_argument("--outputFile")
    ap.add_argument("--bamFile")
    ap.add_argument("--bamFiles")
    ap.add_argument("--region")
    ap.add_argument("--tid")
    ap.add_argument("--varFile")
    ap.add_argument("--varFileIsOneBased", action="store_true")
    ap.add_argument("--outputRealignedBAM", action="store_true")
    ap.add_argument("--processRealignedBAM", default="no")
    ap.add_argument("--outputGLF", action="store_true", default=True,
                    help="output GLF for individuals in each bam file "
                         "(always on, as in the reference: registration is "
                         "commented out at DInDel.cpp:4108 and getParameters "
                         "hardcodes outputGLF=true, DInDel.cpp:3975)")
    ap.add_argument("--noOutputGLF", dest="outputGLF", action="store_false",
                    help="suppress GLF rows (extension; the reference cannot)")
    ap.add_argument("--printCallsOnly", action="store_true",
                    help="print only genotypes where call_lik_ref>0.0001 "
                         "(accepted for parity; the reference consumes it at "
                         "DInDel.cpp:3966 but its only consumer is commented "
                         "out, DInDel.cpp:566-571)")
    ap.add_argument("--quiet", action="store_true")
    ap.add_argument("--doDiploid", action="store_true")
    ap.add_argument("--doPooled", action="store_true")
    ap.add_argument("--insertPrior", action="store_true",
                    help="enable the insert-size positional prior "
                         "(dead code in the reference binary; see "
                         "params_from_args)")
    ap.add_argument("--mapUnmapped", action="store_true",
                    help="remap unmapped reads for which mate is mapped "
                         "(registration commented out in the reference, "
                         "DInDel.cpp:4121; behavior per DInDel.cpp:3980-3982 "
                         "'removed options' + the live getReads path "
                         "DInDel.cpp:1083-1213)")
    ap.add_argument("--faster", action="store_true")
    ap.add_argument("--filterHaplotypes", action="store_true")
    ap.add_argument("--flankRefSeq", type=int, default=2)
    ap.add_argument("--flankMaxMismatch", type=int, default=2)
    ap.add_argument("--priorSNP", type=float, default=1.0 / 1000)
    ap.add_argument("--priorIndel", type=float, default=1.0 / 10000)
    ap.add_argument("--width", type=int, default=60)
    ap.add_argument("--maxHap", type=int, default=8)
    ap.add_argument("--maxRead", type=int, default=10000)
    ap.add_argument("--mapQualThreshold", type=float, default=0.99)
    ap.add_argument("--capMapQualThreshold", type=float, default=100.0)
    ap.add_argument("--capMapQualFast", type=float, default=45.0)
    ap.add_argument("--skipMaxHap", type=int, default=200)
    ap.add_argument("--glfNumHap", type=int, default=5,
                    help="number of haplotypes per glf-class (accepted for "
                         "parity; never consumed by the reference — "
                         "DInDel.cpp:4133,3914 are commented out)")
    ap.add_argument("--numOutputTopHap", type=int, default=5,
                    help="number of haplotype pairs output to haplotype file "
                         "(accepted for parity; its consumer outputTopHaps is "
                         "commented out in the reference, DInDel.cpp:566-571)")
    ap.add_argument("--minReadOverlap", type=int, default=20)
    ap.add_argument("--maxReadLength", type=int, default=500)
    ap.add_argument("--minCount", type=int, default=1)
    ap.add_argument("--maxHapReadProd", type=int, default=10_000_000)
    ap.add_argument("--changeINStoN", action="store_true")
    ap.add_argument("--bayesa0", type=float, default=0.001)
    ap.add_argument("--bayesType", default="singlevariant")
    ap.add_argument("--checkAllCIGARs", type=int, default=1)
    ap.add_argument("--filterReadAux")
    ap.add_argument("--pError", type=float, default=5e-4)
    ap.add_argument("--modelType", default="probabilistic",
                    choices=["probabilistic", "threshold"],
                    help="observation model type (registration commented out "
                         "in the reference, DInDel.cpp:4155; validation per "
                         "ObservationModel.hpp:35-36)")
    ap.add_argument("--pMut", type=float, default=1e-5)
    ap.add_argument("--maxLengthIndel", type=int, default=5)
    ap.add_argument("--pFirstgLO", type=float, default=0.01,
                    help="probability of transition from off the haplotype "
                         "to on the haplotype (registration commented out in "
                         "the reference, DInDel.cpp:4158; default per "
                         "ObservationModel.hpp:54)")
    ap.add_argument("--libFile")
    ap.add_argument("--opl", action="store_true",
                    help="output likelihoods for every read and haplotype")
    # debug/inspection flags (DInDel.cpp:4167-4173)
    ap.add_argument("--compareReadHap", action="store_true",
                    help="compare likelihood differences in reads against "
                         "haplotypes (accepted for CLI parity; its consumer "
                         "is commented out in the reference, "
                         "DInDel.cpp:574-584)")
    ap.add_argument("--compareReadHapThreshold", type=float, default=0.5)
    ap.add_argument("--showEmpirical", action="store_true",
                    help="show empirical distribution over nucleotides")
    ap.add_argument("--showCandHap", action="store_true",
                    help="show candidate haplotypes")
    ap.add_argument("--showHapAlignments", action="store_true",
                    help="show for each haplotype which reads map to it")
    ap.add_argument("--showReads", action="store_true", help="show reads")
    ap.add_argument("--engine", default="streaming",
                    choices=["streaming", "batched"],
                    help="indels engine: 'batched' pipelines many windows "
                         "per device dispatch (the production path); "
                         "'streaming' is the per-window reference path")
    ap.add_argument("--batchWindows", type=int, default=128,
                    help="windows staged per flush (batched engine)")
    ap.add_argument("--maxPairsPerSlab", type=int, default=24576,
                    help="max (hap,read) pairs per device slab "
                         "(bounds backpointer device memory; batched "
                         "engine)")
    ap.add_argument("--stageProcs", type=int, default=0,
                    help="N staging processes feeding this process's "
                         "device via the intra-host device server "
                         "(parallel/hostshard.py); --varFile may be a "
                         "comma-separated list of window files (the "
                         "shard unit)")
    ap.add_argument("--mesh", default=None, metavar="DPxRP",
                    help="shard the batched engine's device slabs over a "
                         "dp x rp jax.sharding.Mesh, e.g. --mesh 4x1 "
                         "(requires dp*rp local devices)")
    ap.add_argument("--inferenceMethod", default="empirical",
                    help="inference method (only 'empirical' does anything, "
                         "as in the reference, DInDel.cpp:1365)")
    ap.add_argument("--hmmBackend", default="jax",
                    choices=["jax", "fused", "oracle"],
                    help="pair-HMM backend: jax (batched XLA kernel), "
                         "fused (one-launch DP kernel, float32; CUDA on "
                         "GPUs), oracle (float64 NumPy)")
    # pipeline subcommand options
    ap.add_argument("--inputVarFile")
    ap.add_argument("--windowFilePrefix")
    ap.add_argument("--minDist", type=int, default=20)
    ap.add_argument("--numWindowsPerFile", type=int, default=1000)
    ap.add_argument("--inputFiles", help="file listing .glf.txt files to merge")
    ap.add_argument("--sampleID", default="SAMPLE")
    ap.add_argument("--maxHPLen", type=int, default=10)
    ap.add_argument("--filterQual", type=int, default=20)
    ap.add_argument("--minQual", type=float, default=1.0,
                    help="convertVCFToDindel QUAL gate "
                         "(python/convertVCFToDindel.py:57)")
    ap.add_argument("--numSamples", type=int, default=0)
    ap.add_argument("--numBAMFiles", type=int, default=0)
    return ap


def params_from_args(args) -> Parameters:
    """getParameters (DInDel.cpp:3907-3989)."""
    p = Parameters()
    p.max_hap = args.maxHap
    p.max_reads = args.maxRead
    p.width = args.width
    p.map_qual_threshold = args.mapQualThreshold
    p.skip_max_hap = args.skipMaxHap
    p.min_read_overlap = args.minReadOverlap
    p.max_read_length = args.maxReadLength
    p.max_hap_read_prod = args.maxHapReadProd
    p.prior_snp = args.priorSNP
    p.prior_indel = args.priorIndel
    p.bayes_a0 = args.bayesa0
    p.bayes_type = args.bayesType
    p.obs_params.p_error = args.pError
    p.obs_params.model_type = args.modelType
    p.obs_params.p_first_g_lo = args.pFirstgLO
    p.obs_params.p_mut = args.pMut
    p.obs_params.max_length_indel = args.maxLengthIndel
    p.obs_params.max_length_del = args.maxLengthIndel
    p.obs_params.map_qual_threshold = args.capMapQualThreshold
    p.obs_params.cap_map_qual_fast = args.capMapQualFast
    p.obs_params.pad_cover = args.flankRefSeq
    p.obs_params.max_mismatch = args.flankMaxMismatch
    p.check_all_cigars = args.checkAllCIGARs
    p.var_file_is_one_based = args.varFileIsOneBased
    p.output_realigned_bam = args.outputRealignedBAM
    p.process_realigned_bam = args.processRealignedBAM
    p.quiet = args.quiet
    p.inference_method = args.inferenceMethod
    p.analyze_low_freq = args.compareReadHap
    p.analyze_low_freq_diff_threshold = args.compareReadHapThreshold
    p.show_hap_dist = args.showEmpirical
    p.show_cand_hap = args.showCandHap
    p.show_reads = args.showReads
    p.show_hap_alignments = args.showHapAlignments
    p.do_diploid = args.doDiploid
    p.estimate_hap_freqs = args.doPooled
    p.filter_haplotypes = args.filterHaplotypes
    p.slower = not args.faster
    p.output_glf = args.outputGLF
    p.print_calls_only = args.printCallsOnly
    p.glf_num_hap = args.glfNumHap
    p.num_output_top_hap = args.numOutputTopHap
    if args.mapUnmapped:
        p.map_unmapped_reads = True
    if args.insertPrior:
        # EXTENSION: the reference SOURCE computes an insert-size
        # positional prior over the haplotype (ObservationModelFB.cpp:
        # 279-294), but the shipped binary never enables it — the
        # obsParams.mapUnmappedReads assignment sits in the removed-
        # options block (DInDel.cpp:3979-3986) so the branch is dead
        # code.  --insertPrior resurrects it explicitly.
        p.obs_params.map_unmapped_reads = True
    p.output_pooled_likelihoods = args.opl
    p.change_ins_to_n = args.changeINStoN
    if args.filterReadAux:
        p.filter_read_aux = args.filterReadAux
    p.ref_file_name = args.ref or ""
    if args.outputFile:
        p.file_name = args.outputFile
    return p


def run_indels(args) -> dict:
    """--analysis indels; returns the engine's RunStats summary."""
    from . import compile_cache
    compile_cache.enable()
    params = params_from_args(args)
    bam_paths = ([args.bamFile] if args.bamFile
                 else [l.split()[0] for l in open(args.bamFiles)])
    libraries = LibraryCollection()
    if args.libFile:
        params.map_unmapped_reads = True
        libraries.add_from_file(args.libFile)
    # The batched engine pipelines host packing/decoding with device
    # slabs (the production path); the streaming engine is the
    # per-window reference path (and the --faster sparse-HMM path).
    use_batched = args.engine == "batched" and params.slower
    dp_impl = "fused" if args.hmmBackend == "fused" else "xla"
    if use_batched and args.stageProcs > 0:
        import numpy as np
        from .parallel.hostshard import run_hostshard
        win_files = args.varFile.split(",")
        out_glf = params.file_name + ".glf.txt"
        run_hostshard(
            bam_paths, args.ref, params, win_files, out_glf,
            n_procs=args.stageProcs,
            engine_kw=dict(batch_windows=args.batchWindows,
                           max_pairs_per_slab=args.maxPairsPerSlab,
                           dp_impl=dp_impl, dtype=np.float32),
            lib_file=args.libFile)
        return {}
    if use_batched:
        import numpy as np
        from .engine.batched import BatchedWindowEngine
        mesh = None
        if args.mesh:
            n_dp, n_rp = (int(t) for t in args.mesh.lower().split("x"))
            mesh = (n_dp, n_rp)
        eng = BatchedWindowEngine(
            bam_paths, args.ref, params, libraries,
            batch_windows=args.batchWindows,
            max_pairs_per_slab=args.maxPairsPerSlab,
            dp_impl=dp_impl, dtype=np.float32, mesh=mesh)
    else:
        from .engine.window import WindowEngine
        eng = WindowEngine(bam_paths, args.ref, params, libraries,
                           hmm_backend=args.hmmBackend)
    eng.detect_indels(args.varFile)
    eng.close()
    return eng.stats.summary()


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    analysis = args.analysis

    if analysis == "getCIGARindels":
        from .engine.candidates import get_candidates, get_candidates_region
        if args.region:
            start, end = parse_region(args.region)
            bams = ([args.bamFile] if args.bamFile
                    else [l.split()[0] for l in open(args.bamFiles)])
            get_candidates_region(bams, args.tid, start, end,
                                  args.outputFile, args.ref)
        else:
            get_candidates(args.bamFile, args.outputFile, args.ref)
        return 0

    if analysis == "indels":
        run_indels(args)
        return 0

    if analysis == "realignCandidates":
        from .engine.candidates import realign_candidate_file
        out = args.outputFile + ".variants.txt"
        realign_candidate_file(args.varFile, args.varFileIsOneBased, out, args.ref)
        return 0

    if analysis == "makeWindows":
        from .pipeline.windows import make_windows
        make_windows(args.inputVarFile, args.windowFilePrefix,
                     min_dist=args.minDist,
                     variants_per_file=args.numWindowsPerFile)
        return 0

    if analysis == "selectCandidates":
        from .pipeline.windows import select_candidates
        select_candidates(args.inputVarFile, args.outputFile,
                          min_count=args.minCount)
        return 0

    if analysis == "mergeOutputDiploid":
        from .pipeline.merge_diploid import merge_output_diploid
        files = [l.split()[0] for l in open(args.inputFiles) if l.strip()]
        merge_output_diploid(files, args.outputFile, args.ref,
                             sample_id=args.sampleID, max_hp_len=args.maxHPLen,
                             filter_qual=args.filterQual)
        return 0

    if analysis == "convertVCFToDindel":
        from .pipeline.genotype_likelihoods import convert_vcf_to_dindel
        convert_vcf_to_dindel(args.inputVarFile, args.outputFile, args.ref,
                              min_qual=args.minQual)
        return 0

    if analysis == "makeGenotypeLikelihoodFilePooled":
        from .pipeline.genotype_likelihoods import make_genotype_likelihood_file
        glfs = [l.split()[0] for l in open(args.inputFiles) if l.strip()]
        bams = [l.split()[0] for l in open(args.bamFiles) if l.strip()]
        make_genotype_likelihood_file(glfs, args.outputFile, args.varFile, bams)
        return 0

    if analysis == "mergeOutputPooled":
        from .pipeline.merge_pooled import merge_output_pooled
        files = [l.split()[0] for l in open(args.inputFiles) if l.strip()]
        merge_output_pooled(files, args.outputFile, args.ref,
                            num_samples=args.numSamples,
                            num_bam_files=args.numBAMFiles)
        return 0

    print(f"Unrecognized --analysis option. {analysis}", file=sys.stderr)
    return 1


def parse_region(region: str):
    """parseRegionString (DInDel.cpp:3892-3905)."""
    filtered = region.replace(",", "").replace("-", " ")
    toks = filtered.split()
    return int(toks[0]), int(toks[1])


if __name__ == "__main__":
    sys.exit(main())
