"""Configuration: the fold's dataclass, mapped 1:1 onto the CLI flags, and the
training constants.

Counterpart of ``dmpfold2_tpu/config.py:FoldConfig`` and ``TrainConfig``.
Three precisions: ``fp32``, ``bf16`` (the trunk in bf16 with fp32
accumulation) and ``fp32_strict``, the fidelity mode for comparing against a
reference run: the fp32 engine with the LU DCA inverse (the reference's
``torch.inverse``) and the raw eigenvector signs of ``eigh``. There is no
``vgru_impl``: the tensor's device chooses each kernel's implementation.
"""

from __future__ import annotations

from dataclasses import dataclass

PRECISIONS = ("fp32", "bf16", "fp32_strict")


def check_precision(precision: str) -> None:
    if precision not in PRECISIONS:
        raise ValueError(f"unknown precision {precision!r}; expected one of {PRECISIONS}")


@dataclass
class FoldConfig:
    # reference-compatible knobs (dmpfold predict.py:26-28, 169-182)
    iterations: int | str = 10       # an int, or "auto"
    minsteps: int = 100
    device: str | None = None        # None means "cuda"
    template: str | None = None
    weights_file: str | None = None

    precision: str = "fp32"
    dca_method: str = "auto"         # "cholesky" | "lu" | "schur" | "blocked";
                                     # auto: engine.fold.resolve_dca_method
    use_buckets: bool = True         # single-target engine only; the batch
                                     # engine always buckets (its batches are buckets)

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
        for name in ("precision", "dca_method"):
            if getattr(args, name, None) is not None:
                setattr(cfg, name, getattr(args, name))
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
