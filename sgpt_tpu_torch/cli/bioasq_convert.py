"""BioASQ → BEIR conversion on the PyTorch port (counterpart of
`sgpt_tpu/cli/bioasq_convert.py`; host only, no model): the reference's
BioASQ preprocessing notebook as one command.

    python -m sgpt_tpu_torch.cli.bioasq_convert \\
        --allmesh allMeSH_2020/allMeSH_2020.json \\
        --questions Task8BGoldenEnriched/Task8BGoldenEnriched \\
        --out datasets/bioasq [--manual-fixes manual-fixes.csv]

Then: `cli.bm25_retriever --dataset bioasq`, `cli.sgptce --dataset bioasq
--bm25results ...`.
"""
from __future__ import annotations

import argparse

from .common import setup_logging


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--allmesh", required=True,
                   help="allMeSH_2020.json (one article per line)")
    p.add_argument("--questions", required=True,
                   help="golden-test directory (BEIR's 500-query split) or "
                        "training8b.json")
    p.add_argument("--out", required=True, help="output BEIR dataset dir")
    p.add_argument("--manual-fixes", default=None, dest="manual_fixes",
                   help="BEIR authors' manual-fixes.csv (ID,TITLE,TEXT)")
    return p.parse_args(argv)


def main(args=None):
    setup_logging()
    args = args or parse_args()
    from ..data.bioasq import convert
    convert(args.allmesh, args.questions, args.out, manual_fixes_csv=args.manual_fixes)


if __name__ == "__main__":
    main()
