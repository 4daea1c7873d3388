"""Convert a JAX (orbax) training checkpoint into the PyTorch port's format.

    python scripts/convert_jax_checkpoint.py JAX_CKPT_DIR OUT_DIR [--step N]

Reads the latest (or the given) state of a ``bignn_tpu`` ``CheckpointManager``
directory (``bignn_tpu.train.trainer._fit_state``'s layout: ``params``,
``opt_state``, ``best_params``, ``meta``) with the JAX package's own manager,
carries ``params`` and ``best_params`` through
``bignn_tpu_torch.bridge.params_from_jax`` and ``meta`` as it is, and writes
``OUT_DIR/step_<n>.pt`` through the port's ``CheckpointManager``. The
result serves (``bignn_tpu_torch.serve.Scorer.from_checkpoint``, ``python -m
bignn_tpu_torch.serve --ckpt OUT_DIR``). Optax's Adam state is not carried
across, so the port's trainers refuse to resume from it rather than restart
Adam from zero moments.

Needs JAX and orbax, so it runs where the JAX package does; the port itself
never imports them.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def convert(src: str, out: str, step: int | None = None) -> int:
    """Convert step ``step`` (default the latest) of the JAX checkpoint
    directory ``src`` into ``out``; returns the step."""
    import jax

    from bignn_tpu.train.checkpoint import CheckpointManager as JaxManager
    from bignn_tpu_torch.bridge import params_from_jax
    from bignn_tpu_torch.train.checkpoint import CheckpointManager

    mgr = JaxManager(src)
    try:
        step = mgr.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {src}")
        state = mgr.restore(step)
    finally:
        mgr.close()

    def params(tree):
        return params_from_jax(jax.tree.map(np.asarray, tree))

    meta = {k: np.asarray(v).item() for k, v in state["meta"].items()}
    CheckpointManager(out).save_state(step, {
        "params": params(state["params"]),
        "best_params": params(state["best_params"]),
        "meta": meta,
    })
    return step


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("src", help="JAX CheckpointManager directory")
    p.add_argument("out", help="the port's checkpoint directory to write")
    p.add_argument("--step", type=int, default=None,
                   help="step to convert (default: the latest)")
    args = p.parse_args(argv)
    step = convert(args.src, args.out, args.step)
    print(f"step {step}: {args.src} -> {os.path.abspath(args.out)}")
    return step


if __name__ == "__main__":
    main()
