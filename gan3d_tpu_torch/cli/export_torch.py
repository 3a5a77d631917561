"""Export a run dir to the reference's torch on-disk layout (counterpart of
gan3d_tpu/cli/export_torch.py).

Writes ``out/params.pkl`` + ``out/models/checkpoint.pt`` with exactly the
keys the reference's trainer writes (trainer.py:153-163), so reference
tooling (its eval.py / tournament.py, or any torch code around those
state_dicts) loads the run directly (eval/export.py). The copy is host
work; like every entry point of the port, the CLI asks for the CUDA card
unless ``--platform=cpu``.

    python -m gan3d_tpu_torch.cli.export_torch --log_dir run --out run_torch
"""

from __future__ import annotations

import argparse

from gan3d_tpu_torch.eval.export import export_checkpoint
from gan3d_tpu_torch.utils.platform import resolve_device


def main(argv=None) -> str:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--log_dir", required=True,
                   help="run dir (params.json + models/checkpoint.pt)")
    p.add_argument("--out", required=True,
                   help="output dir (reference run-dir layout)")
    p.add_argument("--platform", type=str, default="",
                   help="'' = the CUDA card (raises without one), 'cpu'")
    a = p.parse_args(argv)
    resolve_device(a.platform)
    path = export_checkpoint(a.log_dir, a.out)
    print(f"wrote {path} (+ params.pkl)", flush=True)
    return path


if __name__ == "__main__":
    main()
