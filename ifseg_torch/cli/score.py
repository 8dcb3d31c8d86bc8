"""Text-scoring CLI, the port of the JAX package's ``cli/score.py``
(parity with custom_fairseq/fairseq_cli/score.py); it prints the same lines.

Scores whitespace-tokenized system output against references:

    python -m ifseg_torch.cli.score --sys sys.txt --ref ref.txt
    python -m ifseg_torch.cli.score -s sys.txt -r ref.txt --metric rouge
    cat sys.txt | python -m ifseg_torch.cli.score -r ref.txt --sentence-bleu

Extends the reference (BLEU only) with the other scorers of
``utils/scoring.py`` (WER, ROUGE-L, CIDEr-D).
"""

import argparse
import os
import sys

from ifseg_torch.utils.scoring import cider_d, corpus_bleu, rouge_l, wer


def get_parser():
    parser = argparse.ArgumentParser(description="Score system output vs references.")
    parser.add_argument("-s", "--sys", default="-", help="system output ('-' = stdin)")
    parser.add_argument("-r", "--ref", required=True, help="reference file")
    parser.add_argument("-o", "--order", default=4, type=int,
                        help="max n-gram order (bleu/cider)")
    parser.add_argument("--ignore-case", action="store_true")
    parser.add_argument("--sentence-bleu", action="store_true",
                        help="per-sentence smoothed BLEU instead of corpus BLEU")
    parser.add_argument("--metric", default="bleu",
                        choices=["bleu", "wer", "rouge", "cider"])
    return parser


def _read(path, ignore_case):
    fd = sys.stdin if path == "-" else open(path, encoding="utf-8")
    try:
        lines = [ln.rstrip("\n") for ln in fd]
    finally:
        if fd is not sys.stdin:
            fd.close()
    if ignore_case:
        lines = [ln.lower() for ln in lines]
    return [ln.split() for ln in lines]


def cli_main(argv=None):
    args = get_parser().parse_args(argv)
    if args.sys != "-" and not os.path.exists(args.sys):
        raise SystemExit(f"System output file {args.sys} does not exist")
    if not os.path.exists(args.ref):
        raise SystemExit(f"Reference file {args.ref} does not exist")

    hyps = _read(args.sys, args.ignore_case)
    refs = _read(args.ref, args.ignore_case)
    if len(hyps) != len(refs):
        raise SystemExit(
            f"line count mismatch: sys={len(hyps)} ref={len(refs)}"
        )

    if args.metric == "bleu":
        if args.sentence_bleu:
            for i, (h, r) in enumerate(zip(hyps, refs)):
                b = corpus_bleu([h], [r], max_order=args.order, smooth=True)
                print(f"{i} BLEU{args.order} = {b['bleu']:.2f}")
        else:
            b = corpus_bleu(hyps, refs, max_order=args.order)
            precisions = "/".join(f"{p * 100:.1f}" for p in b["precisions"])
            ratio = b["hyp_len"] / max(b["ref_len"], 1)
            print(
                f"BLEU{args.order} = {b['bleu']:.2f}, {precisions} "
                f"(BP={b['brevity_penalty']:.3f}, ratio={ratio:.3f}, "
                f"syslen={b['hyp_len']}, reflen={b['ref_len']})"
            )
    elif args.metric == "wer":
        errs = sum(wer(h, r) * len(r) for h, r in zip(hyps, refs))
        total = sum(len(r) for r in refs)
        print(f"WER = {errs / max(total, 1) * 100:.2f}")
    elif args.metric == "rouge":
        scores = [rouge_l(h, r) for h, r in zip(hyps, refs)]
        f = sum(s["f"] for s in scores) / max(len(scores), 1)
        print(f"ROUGE-L = {f * 100:.2f}")
    elif args.metric == "cider":
        score = cider_d(hyps, [[r] for r in refs], max_order=args.order)
        print(f"CIDEr-D = {score:.3f}")


if __name__ == "__main__":
    cli_main()
