"""Sharding rules and the activation policy (counterpart of
``repro.sharding``)."""

from repro_torch.sharding.rules import (  # noqa: F401
    ShardingRules,
    batch_shardings,
    cache_shardings,
    params_pspecs,
    params_shardings,
    pspec_for,
)
