"""Sweep output aggregation (paper §2.10): records and population summaries.

Port of ``repro/core/aggregate.py``: a finished sweep's stacked
:class:`~repro_torch.core.simulator.SimMetrics` is pulled to the host and
turned into per-instance records and a population digest, with the same
keys, the same per-scenario group-by and the same ``metric_aliases``
renames as the reference.
"""

from __future__ import annotations

from typing import Any, Sequence

import numpy as np
import torch

from repro_torch.core.scenarios import get_scenario

_METRIC_COLUMNS = (
    "throughput", "spawned", "mean_speed", "collisions", "merges_ok",
    "ramp_blocked_steps", "lane_changes", "min_ttc", "steps",
)
_PARAM_COLUMNS = (
    "lambda_main", "lambda_ramp", "p_cav", "v0_mean", "aux0", "aux1",
)


def _np(tree):
    """NamedTuple of tensors (or numpy arrays) → same NamedTuple of numpy
    arrays."""
    return type(tree)(*(np.asarray(x.detach().cpu()) if isinstance(
        x, torch.Tensor) else np.asarray(x) for x in tree))


def _ids(scenario_ids) -> np.ndarray:
    if isinstance(scenario_ids, torch.Tensor):
        scenario_ids = scenario_ids.cpu()
    return np.asarray(scenario_ids).astype(np.int64)


def metrics_to_columns(
    metrics,
    params=None,
    scenario_ids: Any = None,
    scenario_names: Sequence[str] | None = None,
) -> dict[str, np.ndarray]:
    """Stacked ``[N]`` metrics → columnar numpy dataset (one array per field;
    ``lambda_main`` is the one 2-D column)."""
    m = _np(metrics)
    n = m.throughput.shape[0]
    cols: dict[str, np.ndarray] = {"instance": np.arange(n, dtype=np.int64)}
    cols["throughput"] = m.throughput.astype(np.int64)
    cols["spawned"] = m.spawned.astype(np.int64)
    cols["mean_speed"] = (
        m.speed_sum / np.maximum(m.speed_count, 1.0)
    ).astype(np.float64)
    cols["collisions"] = m.collisions.astype(np.int64)
    cols["merges_ok"] = m.merges_ok.astype(np.int64)
    cols["ramp_blocked_steps"] = m.ramp_blocked_steps.astype(np.int64)
    cols["lane_changes"] = m.lane_changes.astype(np.int64)
    cols["min_ttc"] = m.min_ttc.astype(np.float64)
    cols["steps"] = m.steps.astype(np.int64)
    if scenario_ids is not None and scenario_names is not None:
        ids = _ids(scenario_ids)
        cols["scenario_id"] = ids
        cols["scenario"] = np.asarray(scenario_names, dtype=object)[ids]
    if params is not None:
        p = _np(params)
        cols["lambda_main"] = p.lambda_main.astype(np.float64)
        for name in ("lambda_ramp", "p_cav", "v0_mean", "aux0", "aux1"):
            cols[name] = getattr(p, name).astype(np.float64)
    return cols


def metrics_to_records(
    metrics,
    params=None,
    scenario_ids: Any = None,
    scenario_names: Sequence[str] | None = None,
) -> list[dict[str, Any]]:
    """Stacked ``[N]`` metrics → list of per-instance dict records (with the
    scenario's aliased metric names when the roster is given)."""
    return records_from_columns(
        metrics_to_columns(metrics, params, scenario_ids, scenario_names))


def records_from_columns(cols: dict[str, np.ndarray]) -> list[dict[str, Any]]:
    """:func:`metrics_to_columns` output → per-instance dict records (for
    callers that already built the columns, such as the shard writer)."""
    n = cols["instance"].shape[0]
    base_keys = ("instance",) + _METRIC_COLUMNS
    lists = {k: cols[k].tolist() for k in base_keys}
    has_scenario = "scenario" in cols
    has_params = "lambda_main" in cols
    if has_scenario:
        names = cols["scenario"].tolist()
        aliases = {name: get_scenario(name).metric_aliases
                   for name in dict.fromkeys(names)}
    if has_params:
        lists.update({k: cols[k].tolist() for k in _PARAM_COLUMNS})
    records: list[dict[str, Any]] = []
    for i in range(n):
        rec = {k: lists[k][i] for k in base_keys}
        if has_scenario:
            rec["scenario"] = names[i]
            for generic, alias in aliases[names[i]].items():
                rec[alias] = rec[generic]
        if has_params:
            for k in _PARAM_COLUMNS:
                rec[k] = lists[k][i]
        records.append(rec)
    return records


def _summarize(m, sel: np.ndarray) -> dict[str, float]:
    speed = m.speed_sum[sel] / np.maximum(m.speed_count[sel], 1.0)
    total_steps = float(m.steps[sel].sum())
    return {
        "instances": int(sel.sum()),
        "total_throughput": int(m.throughput[sel].sum()),
        "total_spawned": int(m.spawned[sel].sum()),
        "mean_speed": float(speed.mean()),
        "p10_speed": float(np.percentile(speed, 10)),
        "p90_speed": float(np.percentile(speed, 90)),
        "total_collisions": int(m.collisions[sel].sum()),
        "collision_rate_per_kstep": float(
            1000.0 * m.collisions[sel].sum() / max(total_steps, 1.0)
        ),
        "total_merges": int(m.merges_ok[sel].sum()),
        "total_ramp_blocked_steps": int(m.ramp_blocked_steps[sel].sum()),
        "min_ttc": float(m.min_ttc[sel].min()),
        "total_sim_steps": int(total_steps),
    }


_TOTAL_KEYS = {
    "merges_ok": "total_merges",
    "throughput": "total_throughput",
    "spawned": "total_spawned",
    "collisions": "total_collisions",
    "ramp_blocked_steps": "total_ramp_blocked_steps",
}


def aggregate_metrics(
    metrics,
    scenario_ids: Any = None,
    scenario_names: Sequence[str] | None = None,
) -> dict[str, Any]:
    """Population summary over a sweep; with the roster it also carries a
    ``per_scenario`` digest grouped by scenario name."""
    m = _np(metrics)
    out: dict[str, Any] = _summarize(m, np.ones(m.throughput.shape[0], bool))
    if scenario_ids is not None and scenario_names is not None:
        ids = _ids(scenario_ids)
        per: dict[str, Any] = {}
        # group by NAME, not roster slot: a weighted mix may repeat a name
        for name in dict.fromkeys(scenario_names):
            slots = [s for s, nm in enumerate(scenario_names) if nm == name]
            sel = np.isin(ids, slots)
            if not sel.any():
                continue
            sub = _summarize(m, sel)
            for generic, alias in get_scenario(name).metric_aliases.items():
                total_key = _TOTAL_KEYS.get(generic)
                if total_key and total_key in sub:
                    sub[f"total_{alias}"] = sub.pop(total_key)
            per[name] = sub
        out["per_scenario"] = per
    return out
