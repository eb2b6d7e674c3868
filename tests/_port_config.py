"""The port's configs against the JAX package's, field by field.

The port's ``ArchConfig`` and ``MoEConfig`` have fields the JAX package's
lack: DeepSeek-V2's router, dropless and held experts, and YaRN.  Their
defaults are the JAX package's behaviour, so :func:`jax_fields` requires
each to hold its default and leaves it out of the comparison."""
import dataclasses

#: the port's own fields and their defaults
ARCH_ONLY = {"rope_scaling": None}
MOE_ONLY = {"topk_method": "greedy", "n_group": 1, "topk_group": 1, "norm_topk_prob": True,
            "routed_scaling_factor": 1.0, "experts_held": None}


def jax_fields(cfg) -> dict:
    """``dataclasses.asdict(cfg)`` without the port's own fields, each
    checked to hold its default."""
    d = dataclasses.asdict(cfg)
    for key, default in ARCH_ONLY.items():
        assert d.pop(key) == default, key
    if d["moe"] is not None:
        for key, default in MOE_ONLY.items():
            assert d["moe"].pop(key) == default, key
    return d
