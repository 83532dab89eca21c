"""Command-line entry points mirroring the reference CLIs.

marginAlign / marginCaller / marginStats / modifyHmm accept the reference's
flag surface (src/margin/marginAlign.py:16-54, marginCaller.py:12-30,
marginStats.py:13-55, README.md:84).  jobTree
options (--jobTree, --maxThreads, --logInfo, ...) are accepted for drop-in
compatibility and ignored: scheduling is in-process JAX dispatch.
"""
from __future__ import annotations

import argparse
import os
import sys
import tempfile

import numpy as np

from .utils.compile_cache import configure_compile_cache


def _default_model_path() -> str:
    return os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "models", "last_hmm_20.txt"
    )


def _add_ignored_jobtree_options(parser: argparse.ArgumentParser) -> None:
    g = parser.add_argument_group("compatibility (accepted, ignored)")
    g.add_argument("--jobTree", default=None, help=argparse.SUPPRESS)
    g.add_argument("--maxThreads", default=None, help=argparse.SUPPRESS)
    g.add_argument("--logInfo", action="store_true", help=argparse.SUPPRESS)
    g.add_argument("--logDebug", action="store_true", help=argparse.SUPPRESS)
    g.add_argument("--logLevel", default=None, help=argparse.SUPPRESS)
    g.add_argument("--batchSystem", default=None, help=argparse.SUPPRESS)
    g.add_argument("--defaultMemory", default=None, help=argparse.SUPPRESS)


def margin_align_main(argv=None) -> int:
    configure_compile_cache()
    from .align.guide import GuideConfig, map_reads
    from .align.chain import chain_sam_file
    from .align.em import EmOptions, normalise_trained_hmm, train_em
    from .align.realign import realign_sam_file, _jobs_from_sam
    from .io.sam import SamFile
    from .io.fasta import get_fasta_dictionary
    from .models.hmm import PairHmm
    from .utils.seq import encode

    p = argparse.ArgumentParser(
        prog="marginAlign",
        description="Align a FASTQ of nanopore reads to a reference FASTA, "
        "emitting SAM (JAX reimplementation).",
    )
    p.add_argument("inputFastqFile")
    p.add_argument("referenceFastaFile")
    p.add_argument("outputSamFile")
    p.add_argument("--em", action="store_true",
                   help="Run expectation maximisation (EM)")
    p.add_argument("--bwa", action="store_true",
                   help="Use the BWA-style seed preset instead of LAST-style")
    p.add_argument("--minimap2", action="store_true",
                   help="Use the minimap2-style seed preset (primary only)")
    p.add_argument("--noRealign", action="store_true",
                   help="Don't run any realignment step")
    p.add_argument("--noChain", action="store_true",
                   help="Don't run any chaining step")
    p.add_argument("--gapGamma", type=float, default=0.5,
                   help="Gap gamma for the AMAP function (default 0.5)")
    p.add_argument("--matchGamma", type=float, default=0.0,
                   help="Match gamma for the AMAP function (default 0.0)")
    p.add_argument("--inputModel", default=_default_model_path(),
                   help="Input HMM model file")
    p.add_argument("--outputModel", default=None,
                   help="Where to write the EM-trained model")
    # EM options (cPecanEm.Options surface, marginAlign.py:38-53).
    p.add_argument("--modelType", default="fiveStateAsymmetric",
                   choices=["fiveState", "fiveStateAsymmetric", "threeState",
                            "threeStateAsymmetric"],
                   help="HMM model family for EM training")
    p.add_argument("--trials", type=int, default=3)
    p.add_argument("--iterations", type=int, default=100)
    p.add_argument("--noRandomStart", action="store_true")
    p.add_argument("--maxAlignmentLengthToSample", type=int,
                   default=50_000_000)
    p.add_argument("--emCheckpoint", default=None,
                   help="Checkpoint file for EM training (resume-capable)")
    # The reference defaults outputTrialHmms ON (marginAlign.py:43).
    p.add_argument("--outputTrialHmms", action="store_true", default=True,
                   help="Write each EM trial's model to <outputModel>.trialN "
                        "(default on, like the reference)")
    p.add_argument("--noOutputTrialHmms", dest="outputTrialHmms",
                   action="store_false",
                   help="Don't write per-trial EM models")
    p.add_argument("--useDefaultModelAsStart", action="store_true",
                   help="Start EM trial 0 from the input model instead of "
                        "a random start (reference: useDefaultModelAsStart, "
                        "marginAlign.py:49)")
    p.add_argument("--updateTheBand", action="store_true",
                   help="Re-derive the EM band each iteration by "
                        "MEA-realigning the training pairs with the "
                        "current model (cPecanEm updateTheBand; the "
                        "reference ships the flag commented out, "
                        "marginAlign.py:50)")
    p.add_argument("--tieEmissions", action="store_true",
                   help="Tie short/long gap-state emissions during EM")
    p.add_argument("--setJukesCantorStartingEmissions", type=float,
                   default=None, metavar="RATE",
                   help="Start EM emissions from a Jukes-Cantor matrix")
    p.add_argument("--outputXMLModelFile", default=None,
                   help="Also write the trained model as XML")
    p.add_argument("--maxAlignmentLengthPerJob", type=int, default=700_000,
                   help="Accepted for compatibility; batching is automatic")
    p.add_argument("--splitMatrixBiggerThanThis", type=int, default=3000,
                   help="Split DP problems at guide anchors so no side "
                        "exceeds this (reference realign default 3000; "
                        "0 = exact full-length DP)")
    _add_ignored_jobtree_options(p)
    args = p.parse_args(argv)

    preset = "bwa" if args.bwa else ("minimap2" if args.minimap2 else "last")
    cfg = GuideConfig.preset(preset)

    if args.noRealign:
        if args.noChain:
            map_reads(args.inputFastqFile, args.referenceFastaFile,
                      args.outputSamFile, cfg)
        else:
            with tempfile.NamedTemporaryFile(suffix=".sam") as tmp:
                map_reads(args.inputFastqFile, args.referenceFastaFile,
                          tmp.name, cfg)
                chain_sam_file(tmp.name, args.outputSamFile,
                               args.inputFastqFile, args.referenceFastaFile)
        return 0

    with tempfile.NamedTemporaryFile(suffix=".sam") as tmp:
        map_reads(args.inputFastqFile, args.referenceFastaFile, tmp.name, cfg)

        hmm = PairHmm.load(args.inputModel)
        if args.em:
            # Train on the (optionally chained) guide alignments, then
            # realign with the trained model (marginAlignLib.py:279-297).
            chained = tmp.name
            tmp2 = None
            if not args.noChain:
                tmp2 = tempfile.NamedTemporaryFile(suffix=".sam", delete=False)
                tmp2.close()
                chain_sam_file(tmp.name, tmp2.name, args.inputFastqFile,
                               args.referenceFastaFile)
                chained = tmp2.name
            sam = SamFile.read(chained)
            refs = get_fasta_dictionary(args.referenceFastaFile)
            jobs = _jobs_from_sam(sam, refs, encode)
            opts = EmOptions(
                model_type=args.modelType,
                trials=args.trials,
                iterations=args.iterations,
                random_start=not args.noRandomStart,
                max_alignment_length_to_sample=args.maxAlignmentLengthToSample,
                tie_emissions=args.tieEmissions,
                output_trial_hmms_path=(
                    args.outputModel if args.outputTrialHmms else None
                ),
                jukes_cantor_start=args.setJukesCantorStartingEmissions,
                use_default_model_as_start=args.useDefaultModelAsStart,
                update_band_every=1 if args.updateTheBand else 0,
            )
            best = train_em(jobs, opts, input_hmm=hmm,
                            log_fn=lambda s: print(s, file=sys.stderr),
                            checkpoint_path=args.emCheckpoint)
            hmm = normalise_trained_hmm(best.hmm)
            hmm.likelihood = best.likelihood
            if args.outputModel:
                hmm.write(args.outputModel)
            if args.outputXMLModelFile:
                hmm.write_xml(args.outputXMLModelFile)
            if tmp2 is not None:
                os.unlink(tmp2.name)

        realign_sam_file(
            tmp.name, args.outputSamFile, args.inputFastqFile,
            args.referenceFastaFile, hmm,
            gap_gamma=args.gapGamma, match_gamma=args.matchGamma,
            no_chain=args.noChain,
            split_size=args.splitMatrixBiggerThanThis,
        )
    return 0


def margin_caller_main(argv=None) -> int:
    configure_compile_cache()
    from .call.caller import CallerOptions, margin_caller
    from .models.hmm import PairHmm

    p = argparse.ArgumentParser(
        prog="marginCaller",
        description="Call SNVs from a SAM + reference, emitting VCF "
        "(JAX reimplementation).",
    )
    p.add_argument("inputSamFile")
    p.add_argument("referenceFastaFile")
    p.add_argument("outputVcfFile")
    p.add_argument("--noMargin", action="store_true",
                   help="Use the input alignment directly instead of "
                   "marginalising over alignments")
    p.add_argument("--alignmentModel", default=_default_model_path())
    p.add_argument("--errorModel", default=_default_model_path())
    p.add_argument("--threshold", type=float, default=0.3)
    p.add_argument("--maxAlignmentLengthPerJob", type=int, default=7_000_000,
                   help="Accepted for compatibility; batching is automatic")
    p.add_argument("--splitMatrixBiggerThanThis", type=int, default=100,
                   help="Split DP problems at guide anchors so no side "
                        "exceeds this (reference caller default 100; "
                        "0 = exact full-length DP)")
    _add_ignored_jobtree_options(p)
    args = p.parse_args(argv)

    margin_caller(
        args.inputSamFile, args.referenceFastaFile, args.outputVcfFile,
        alignment_model=PairHmm.load(args.alignmentModel),
        error_model=PairHmm.load(args.errorModel),
        options=CallerOptions(threshold=args.threshold,
                              no_margin=args.noMargin,
                              split_size=args.splitMatrixBiggerThanThis),
    )
    return 0


def margin_stats_main(argv=None) -> int:
    configure_compile_cache()
    from .stats.stats import ReadAlignmentStats

    p = argparse.ArgumentParser(
        prog="marginStats",
        description="Alignment statistics from a SAM file.",
    )
    p.add_argument("samFile")
    p.add_argument("readFastqFile")
    p.add_argument("referenceFastaFile")
    p.add_argument("--readIdentity", action="store_true")
    p.add_argument("--alignmentIdentity", action="store_true")
    p.add_argument("--readCoverage", action="store_true")
    p.add_argument("--mismatchesPerAlignedBase", action="store_true")
    p.add_argument("--deletionsPerReadBase", action="store_true")
    p.add_argument("--insertionsPerReadBase", action="store_true")
    p.add_argument("--readLength", action="store_true")
    p.add_argument("--localAlignment", action="store_true",
                   help="Ignore unaligned read prefix/suffix")
    p.add_argument("--printValuePerReadAlignment", action="store_true")
    p.add_argument("--noStats", action="store_true")
    _add_ignored_jobtree_options(p)
    args = p.parse_args(argv)

    stats = ReadAlignmentStats.get_read_alignment_stats(
        args.samFile, args.readFastqFile, args.referenceFastaFile,
        global_alignment=not args.localAlignment,
    )

    def report(values, name):
        if not args.noStats:
            print("Average" + name, np.average(values))
            print("Median" + name, np.median(values))
            print("Min" + name, min(values))
            print("Max" + name, max(values))
        if args.printValuePerReadAlignment:
            print("Values" + name, "\t".join(map(str, values)))

    if args.readIdentity:
        report([s.read_identity() for s in stats], "ReadIdentity")
    if args.alignmentIdentity:
        report([s.alignment_identity() for s in stats], "AlignmentIdentity")
    if args.readCoverage:
        report([s.read_coverage() for s in stats], "ReadCoverage")
    if args.mismatchesPerAlignedBase:
        report([s.mismatches_per_aligned_base() for s in stats],
               "MismatchesPerAlignedBase")
    if args.deletionsPerReadBase:
        report([s.deletions_per_read_base() for s in stats],
               "DeletionsPerReadBase")
    if args.insertionsPerReadBase:
        report([s.insertions_per_read_base() for s in stats],
               "InsertionsPerReadBase")
    if args.readLength:
        report([s.read_length() for s in stats], "ReadLength")
    return 0


def modify_hmm_main(argv=None) -> int:
    from .models.hmm import PairHmm

    p = argparse.ArgumentParser(
        prog="modifyHmm",
        description="HMM surgery: substitution-rate relaxation, GC "
        "renormalisation, flat indel emissions (reference: scripts/modifyHmm "
        "-> cPecanModifyHmm; math at marginAlignLib.py:238-263).",
    )
    p.add_argument("inputHmm")
    p.add_argument("outputHmm")
    p.add_argument("--substitutionRate", type=float, default=None)
    p.add_argument("--gcContent", type=float, default=None)
    p.add_argument("--setFlatIndelEmissions", action="store_true")
    args = p.parse_args(argv)

    hmm = PairHmm.load(args.inputHmm)
    if args.setFlatIndelEmissions:
        hmm.set_flat_indel_emissions()
    if args.gcContent is not None:
        hmm.normalise_by_gc_content(args.gcContent)
    if args.substitutionRate is not None:
        hmm.modify_by_substitution_rate(args.substitutionRate)
    hmm.write(args.outputHmm)
    return 0
