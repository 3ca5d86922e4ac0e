"""The calls into the program under test (``sessionrec_tpu_torch``) that
every driver shares: the model of a configuration, with the benchmark's
weights loaded into it by name."""

from __future__ import annotations


def build_model(cfg, device):
    """The port's model of configuration ``cfg`` on ``device``."""
    from sessionrec_tpu_torch.models import build_model as build
    from sessionrec_tpu_torch.utils.config import ModelConfig
    return build(ModelConfig(**cfg["model"]),
                 cfg["catalog"]["num_items"]).to(device)


def load_weights(model, weights):
    """Copy ``weights`` (by parameter name) into ``model``'s parameters in
    place, then the model's max-norm projection; the table's rows past
    the catalog (the program's padding) are zeroed.  The names and shapes
    must match."""
    import torch
    params = dict(model.named_parameters())
    if set(params) != set(weights):
        raise ValueError(f"parameters differ: program only "
                         f"{sorted(set(params) - set(weights))}, benchmark "
                         f"only {sorted(set(weights) - set(params))}")
    with torch.no_grad():
        for name, w in weights.items():
            p = params[name]
            if name == "embedding":
                p.zero_()
                p[:w.shape[0]].copy_(w)
            elif p.shape != w.shape:
                raise ValueError(f"{name}: {tuple(p.shape)} in the program, "
                                 f"{tuple(w.shape)} in the benchmark")
            else:
                p.copy_(w)
        model.project_params()


def leaf_norms(tensors, n_items):
    """``{name: float norm}`` of ``tensors``, the table over its catalog
    rows only."""
    import torch
    return {n: float(torch.linalg.vector_norm(
        (t[:n_items] if n == "embedding" else t).float()))
        for n, t in tensors.items()}


def synchronize(device):
    import torch
    if device == "cuda":
        torch.cuda.synchronize()


def peak_memory(device):
    import torch
    return torch.cuda.max_memory_allocated() if device == "cuda" else 0


def free(device):
    import gc
    import torch
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
