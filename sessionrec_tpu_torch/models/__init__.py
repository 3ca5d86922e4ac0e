"""Models of the port: SRGNN, NISER, LESSR and MSGIFSR (reference
src/models/__init__.py)."""

from sessionrec_tpu_torch.models.lessr import LESSR  # noqa: F401
from sessionrec_tpu_torch.models.msgifsr import MSGIFSR  # noqa: F401
from sessionrec_tpu_torch.models.niser import NISER  # noqa: F401
from sessionrec_tpu_torch.models.srgnn import SRGNN  # noqa: F401

_REGISTRY = {"srgnn": SRGNN, "niser": NISER, "lessr": LESSR,
             "msgifsr": MSGIFSR}


def graph_kind(name: str) -> str:
    """The batch kind that model ``name`` reads: 'session', 'lessr' or
    'ccs'."""
    return _REGISTRY[name.lower()].graph_kind


def build_model(cfg, num_items: int):
    """Instantiate a model from a ModelConfig + catalog size."""
    name = cfg.name.lower()
    if name not in _REGISTRY:
        raise ValueError(f"unknown model {cfg.name!r}; have "
                         f"{sorted(_REGISTRY)}")
    return _REGISTRY[name].from_config(cfg, num_items)
