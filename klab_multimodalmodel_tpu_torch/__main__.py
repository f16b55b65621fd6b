"""``python -m klab_multimodalmodel_tpu_torch
{train,eval,caption,convert-hf,export-hf,serve} ...``: the console entry points
of ``cli.py``, each with its own flags."""

from __future__ import annotations

import sys

from . import cli

COMMANDS = {"train": cli.main, "eval": cli.eval_main,
            "caption": cli.caption_main, "convert-hf": cli.convert_hf_main,
            "export-hf": cli.export_hf_main, "serve": cli.serve_main}


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    if not argv or argv[0] not in COMMANDS:
        print(f"usage: python -m klab_multimodalmodel_tpu_torch "
              f"{{{','.join(COMMANDS)}}} [flags]", file=sys.stderr)
        return 2
    COMMANDS[argv[0]](argv[1:])
    return 0


if __name__ == "__main__":
    sys.exit(main())
