"""Configuration: the fold's dataclass, mapped 1:1 onto the CLI flags, and the
training constants.

Counterpart of ``dmpfold2_tpu/config.py:FoldConfig`` and ``TrainConfig``.
The port runs two precisions, ``fp32`` and ``bf16``; ``fp32_strict`` is not
ported yet (ROADMAP.md, queue 1).
"""

from __future__ import annotations

from dataclasses import dataclass

PRECISIONS = ("fp32", "bf16")
NOT_PORTED_PRECISIONS = ("fp32_strict",)


def check_precision(precision: str) -> None:
    if precision in NOT_PORTED_PRECISIONS:
        raise NotImplementedError(
            f"precision {precision!r} is not yet ported to the PyTorch "
            "package (ROADMAP.md, queue 1); use precision='fp32' or 'bf16'")
    if precision not in PRECISIONS:
        raise ValueError(f"unknown precision {precision!r}; expected one of "
                         f"{PRECISIONS + NOT_PORTED_PRECISIONS}")


@dataclass
class FoldConfig:
    # reference-compatible knobs (dmpfold predict.py:26-28, 169-182)
    iterations: int | str = 10       # an int, or "auto"
    minsteps: int = 100
    device: str | None = None        # None means "cuda"
    template: str | None = None
    weights_file: str | None = None

    precision: str = "fp32"

    @classmethod
    def from_cli_args(cls, args) -> "FoldConfig":
        template = args.template
        if isinstance(template, (list, tuple)):
            template = template[0] if template else None
        if template == "-":
            template = None
        cfg = cls(
            iterations=args.iterations,
            minsteps=args.minsteps,
            device=args.device,
            template=template,
            weights_file=args.model_weights,
        )
        if getattr(args, "precision", None) is not None:
            cfg.precision = args.precision
        return cfg


@dataclass
class TrainConfig:
    """Training constants (reference train.py:21-33), as the JAX package's
    ``config.TrainConfig``."""

    batch_size: int = 32             # gradient-accumulation span, in samples
    max_aln_size: int = 300 * 1000   # MSA area budget
    crop_len: int = 350
    max_iterations: int = 3          # max recycling loops
    restart: bool = True
    refine_steps: int = 100
    micro_batch: int = 1
    learning_rate_restart: float = 1e-4
    learning_rate_scratch: float = 3e-4
