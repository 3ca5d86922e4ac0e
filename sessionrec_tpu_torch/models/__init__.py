"""Models of the port: MSGIFSR so far (order 1 and the order-3 paper
head)."""

from sessionrec_tpu_torch.models.msgifsr import MSGIFSR  # noqa: F401

_REGISTRY = {"msgifsr": MSGIFSR}


def build_model(cfg, num_items: int):
    """Instantiate a model from a ModelConfig + catalog size."""
    name = cfg.name.lower()
    if name not in _REGISTRY:
        raise NotImplementedError(
            f"model {cfg.name!r} is not ported yet (ROADMAP.md, 'The other "
            f"three model families'); the port has {sorted(_REGISTRY)}")
    return _REGISTRY[name].from_config(cfg, num_items)
