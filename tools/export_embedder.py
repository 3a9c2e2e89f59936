"""Export the trained ArcFace embedder from the JAX package's orbax
checkpoint to a checkpoint of the PyTorch port (``facerec_torch``).

    python tools/export_embedder.py
    python tools/export_embedder.py --src outputs/checkpoints/arcface_synth/best \\
                                    --out outputs/checkpoints/arcface_synth

Reads ``--src`` with the JAX package's ``load_checkpoint`` (orbax, so this
needs JAX; the port itself never imports it), carries ``params`` and
``batch_stats`` over with ``facerec_torch.convert.from_jax(tree,
"arcface")`` and writes ``<out>/final`` with the port's ``save_checkpoint``
(``state.pt`` and ``metadata.json``). ``build_embedder(checkpoint=
"<out>/final")`` loads it, and so does ``build_default_pipeline`` when
``<out>`` is ``outputs/checkpoints/<name>``. The output is ``final``, not
``best``: ``best`` holds the orbax tree, and the saver replaces the
directory it writes. ``.gitignore`` lists the default output; no weights are
committed.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
DEFAULT_SRC = ROOT / "outputs/checkpoints/arcface_synth/best"
OUT_NAME = "final"


def export_embedder(src: str | Path = DEFAULT_SRC, out: str | Path | None = None) -> Path:
    """Convert the orbax checkpoint ``src`` and write ``<out>/final``
    (default ``out``: the directory above ``src``). Returns the written
    checkpoint's directory."""
    from facerec_torch.convert import from_jax
    from facerec_torch.train.checkpoints import save_checkpoint
    from facerec_tpu.train.checkpoints import load_checkpoint

    src = Path(src).resolve()
    out = src.parent if out is None else Path(out)
    tree = load_checkpoint(src.parent, src.name)
    state = from_jax({"params": tree["params"], "batch_stats": tree["batch_stats"]}, "arcface")
    meta = dict(tree.get("metadata", {}), exported_from=str(src))
    return save_checkpoint(out, OUT_NAME, state, metadata=meta)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        description="Export the orbax ArcFace checkpoint as a facerec_torch checkpoint.")
    ap.add_argument("--src", default=str(DEFAULT_SRC), help="the orbax checkpoint directory")
    ap.add_argument("--out", default=None,
                    help="the model directory to write final/ into (default: the parent of --src)")
    args = ap.parse_args(argv)
    path = export_embedder(args.src, args.out)
    print(f"wrote {path}")
    return 0


if __name__ == "__main__":
    sys.path.insert(0, str(ROOT))
    sys.exit(main())
