"""Standing up a configuration's deployment through the port's entry points.

A configuration file names its ``kind``: ``"ivf_pq"`` (an IVF-PQ index over
a resident corpus, ``reductive_tpu_torch.ivf``) or ``"opq"`` (an OPQ
quantizer over a resident corpus, ``reductive_tpu_torch.pq``).  Every draw
comes from the run's seed (:mod:`benchmark.data`); the port gets only the
inputs made here.
"""

from __future__ import annotations

import torch

from benchmark import data


def prepare(ctx) -> None:
    """Builds the port's kernel libraries where the run has a card (every
    source at once; later runs of a checkout find them built)."""
    if torch.device(ctx.device).type == "cuda":
        from reductive_tpu_torch import ops

        ops.build_all()
    ctx.mark("libraries")


def apply_control(ctx, known) -> None:
    """Checks the run's control against the driver's ``known`` ones and
    applies those the drivers share, for the rest of the process:
    ``"tf32"``, the program's float32 matrix products in TF32 (the
    configuration states float32 with TF32 off); ``"frozen"``, a fault
    planted in the program: Lloyd's steps that return their state unchanged
    (IVF-PQ training keeps its k-means++ seeds and its initial codebooks)."""
    if ctx.control is None:
        return
    if ctx.control not in known:
        raise ValueError(f"unknown control {ctx.control!r} (this cell has {', '.join(known)})")
    if ctx.control == "tf32":
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
    if ctx.control == "frozen":
        _freeze_lloyd()


def _freeze_lloyd() -> None:
    from reductive_tpu_torch import ivf
    from reductive_tpu_torch.pq import Pq, train

    def residual_pq(generator, x, m, bits, iterations, **kwargs):
        return Pq(codebooks=train.init_codebooks_random(x, generator, 2 ** bits, x.shape[1] // m))

    ivf._coarse_stage = lambda x, init, iterations, **kwargs: init
    train.train_pq_chunked = residual_pq


def corpus(ctx) -> torch.Tensor:
    cfg = ctx.config
    gen = data.generator(ctx.device, ctx.seed, "corpus")
    return data.corpus(cfg["data"], gen, cfg["rows"], cfg["dim"])


def queries(ctx, x: torch.Tensor) -> torch.Tensor:
    cfg = ctx.config
    gen = data.generator(ctx.device, ctx.seed, "queries")
    return data.queries_near_rows(gen, x, cfg["queries"], cfg["query_noise"])


def ivf_train(ctx, x: torch.Tensor, tag: str = "train"):
    """``(coarse, pq)`` from ``train_ivf_pq`` with the configuration's
    sample and iterations."""
    from reductive_tpu_torch import ivf

    cfg = ctx.config
    gen = data.generator(ctx.device, ctx.seed, tag)
    return ivf.train_ivf_pq(gen, x, cfg["n_cells"], cfg["pq_m"], cfg["pq_bits"],
                            coarse_iterations=cfg["coarse_iterations"],
                            pq_iterations=cfg["pq_iterations"],
                            train_sample=cfg["train_sample"])


def ivf_build(ctx, x: torch.Tensor, coarse: torch.Tensor, pq):
    from reductive_tpu_torch import ivf

    cfg = ctx.config
    return ivf.build_ivf(coarse, pq, x, capacity=cfg["capacity"], on_overflow=cfg["on_overflow"],
                         placement=cfg["placement"])


def opq_train(ctx, x: torch.Tensor):
    """The OPQ quantizer, trained on a sample of the corpus drawn from the
    seed (``train_opq_chunked``, the configuration's alternations)."""
    from reductive_tpu_torch.pq.opq import train_opq_chunked

    cfg = ctx.config
    gen = data.generator(ctx.device, ctx.seed, "train")
    sample = x[data.distinct_rows(gen, x.shape[0], min(cfg["train_sample"], x.shape[0]))]
    return train_opq_chunked(gen, sample, cfg["pq_m"], cfg["pq_bits"], cfg["opq_iterations"])


def encode_all(ctx, pq, x: torch.Tensor) -> torch.Tensor:
    """``(n, m)`` uint8 codes of the whole corpus, in the configuration's
    encode batches, by the quantizer's kernel encode."""
    batch = ctx.config["encode_batch"]
    codes = torch.empty((x.shape[0], pq.quantized_len), dtype=torch.uint8, device=x.device)
    for off in range(0, x.shape[0], batch):
        codes[off:off + batch] = pq.quantize_batch(x[off:off + batch], method="kernel")
    return codes
