"""Data-parallel sharding of the pair-HMM pipeline over a device mesh.

The reference's only parallelism is embarrassingly-parallel data parallelism
over read chunks via jobTree child processes, reduced through pickled files
(src/margin/utils.py:127-180, src/margin/marginCallerLib.py:171-187).  Here
the same strategy is a one-axis ``jax.sharding.Mesh``: read lanes shard over
the "data" axis, the banded wavefront runs per shard, and expectation
tensors merge with ``jax.lax.psum`` (NCCL between the GPUs of a host, which
NVLink joins all to all, so the mesh is one flat axis).

Tensor/pipeline/expert parallelism are deliberately absent: the model is
5x5 transitions + 5x16 emissions (SURVEY.md §2.3) — there is nothing to
shard but the data.  The sequence dimension is handled by banding (the
reference's diagonalExpansion/splitMatrix analog), not ring collectives.
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from ..models.hmm import GAP_X_STATES
from ..ops.fb import DeviceBatch, FbTables, forward_backward


def shard_map(f, *, mesh, in_specs, out_specs):
    """jax.shard_map without varying-manual-axes checks: the FB engine's
    scan carries start from replicated constants and mix with lane-sharded
    inputs, and every output here is either lane-sharded or psummed."""
    return jax.shard_map(
        f, mesh=mesh, in_specs=in_specs, out_specs=out_specs, check_vma=False
    )


def make_data_mesh(devices=None) -> Mesh:
    devices = np.asarray(devices if devices is not None else jax.devices())
    return Mesh(devices.reshape(-1), ("data",))


# Per-field PartitionSpecs for DeviceBatch: lanes (last axis) shard over data.
_BATCH_SPECS = DeviceBatch(
    xb=P(None, None, "data"),
    yb=P(None, None, "data"),
    valid=P(None, None, "data"),
    s1=P(None, "data"),
    s2=P(None, "data"),
    final_d=P("data"),
    final_k=P("data"),
)


class EmStepResult(NamedTuple):
    trans_counts: jnp.ndarray  # [5, 5] globally summed
    emit_match: jnp.ndarray    # [5, 5]
    emit_gap: jnp.ndarray      # [5, 5]
    log_likelihood: jnp.ndarray  # scalar, globally summed
    new_transitions: jnp.ndarray  # [5, 5] M-step output
    new_emissions: jnp.ndarray    # [5, 16] M-step output


def m_step_jnp(
    transitions: jnp.ndarray,  # previous [5, 5]
    emissions: jnp.ndarray,    # previous [5, 16]
    tc: jnp.ndarray,
    em: jnp.ndarray,
    eg: jnp.ndarray,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Row-renormalise expected counts (device-side M-step mirroring
    align/em._m_step)."""
    row = tc.sum(axis=1, keepdims=True)
    new_t = jnp.where(row > 0, tc / jnp.maximum(row, 1e-30), transitions)

    m4 = em[:4, :4]
    new_match = jnp.where(
        m4.sum() > 0, (m4 / jnp.maximum(m4.sum(), 1e-30)).reshape(-1),
        emissions[0],
    )
    new_e = [new_match]
    for s in range(1, 5):
        marg = eg[s, :4]
        tot = marg.sum()
        margn = marg / jnp.maximum(tot, 1e-30)
        if s in GAP_X_STATES:
            e = jnp.repeat(margn[:, None] / 4.0, 4, axis=1)
        else:
            e = jnp.repeat(margn[None, :] / 4.0, 4, axis=0)
        new_e.append(jnp.where(tot > 0, e.reshape(-1), emissions[s]))
    return new_t, jnp.stack(new_e)


def make_em_train_step(mesh: Mesh):
    """Build the jitted, mesh-sharded EM training step: banded FB expected
    counts per shard -> psum -> M-step.  Inputs: model tables + transitions/
    emissions + a DeviceBatch whose lane dimension is sharded over 'data'."""

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(
            (P(), P(), P(), P()),  # tables (replicated)
            _BATCH_SPECS,
        ),
        out_specs=(P(), P(), P(), P()),
    )
    def _counts(tables_tuple, batch):
        res = forward_backward(
            FbTables(*tables_tuple), batch, want_posteriors=False,
            want_counts=True,
        )
        tc = jax.lax.psum(res.trans_counts, "data")
        em = jax.lax.psum(res.emit_match, "data")
        eg = jax.lax.psum(res.emit_gap, "data")
        ll = jax.lax.psum(jnp.sum(res.logZ), "data")
        return tc, em, eg, ll

    @jax.jit
    def em_train_step(
        tables: FbTables,
        transitions: jnp.ndarray,
        emissions: jnp.ndarray,
        batch: DeviceBatch,
    ) -> EmStepResult:
        tc, em, eg, ll = _counts(tuple(tables), batch)
        new_t, new_e = m_step_jnp(transitions, emissions, tc, em, eg)
        return EmStepResult(tc, em, eg, ll, new_t, new_e)

    return em_train_step


def make_sharded_fb(mesh: Mesh, want_posteriors: bool = True):
    """Mesh-sharded posterior computation (realign / caller paths): each
    device computes posteriors for its lanes; outputs stay lane-sharded."""

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=((P(), P(), P(), P()), _BATCH_SPECS),
        out_specs=(P("data"), P(None, None, "data")),
    )
    def _fb(tables_tuple, batch):
        tables = FbTables(*tables_tuple)
        res = forward_backward(
            tables, batch, want_posteriors=want_posteriors, want_counts=False
        )
        return res.logZ, res.posteriors

    return jax.jit(lambda tables, batch: _fb(tuple(tables), batch))


def make_sharded_caller_expectations(mesh: Mesh, width: int, rg: int):
    """Mesh-sharded caller expectation merge: each device reduces its lane
    shard of the posterior band into a [rg, 4] partial (the banded
    monotone segment-sum of ops/expectations.py) and the partials merge
    with one psum over the data axis — the reference's pickled-chunk
    summation (src/margin/marginCallerLib.py:179-187) as a collective.

    Inputs mirror ops.expectations._expectations_device, lane-sharded on
    the last axis: post/valid/yb [D1, Wp, B], lo [D1, B], e1 [VE, B]."""
    from ..ops.expectations import _expectations_device

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(
            P(None, None, "data"), P(None, None, "data"),
            P(None, None, "data"), P(None, "data"), P(None, "data"),
        ),
        out_specs=P(),
    )
    def _exp(post, valid, yb, lo, e1):
        local = _expectations_device(
            post, valid, yb, lo, e1, width=width, rg=rg
        )
        return jax.lax.psum(jnp.sum(local, axis=2).T, "data")

    return jax.jit(_exp)


def pad_batch_lanes(batch_np, n_devices: int):
    """Round the packed batch's lane count up to a multiple of n_devices
    (shard_map needs even sharding)."""
    from ..ops.band import BandedBatch

    B = batch_np.batch
    target = -(-B // n_devices) * n_devices
    if target == B:
        return batch_np
    pad = target - B

    def padlane(a):
        widths = [(0, 0)] * (a.ndim - 1) + [(0, pad)]
        return np.pad(a, widths)

    return BandedBatch(
        xb=padlane(batch_np.xb), yb=padlane(batch_np.yb),
        valid=padlane(batch_np.valid), s1=padlane(batch_np.s1),
        s2=padlane(batch_np.s2), lo=padlane(batch_np.lo),
        final_d=padlane(batch_np.final_d), final_k=padlane(batch_np.final_k),
        m=padlane(batch_np.m), n=padlane(batch_np.n), width=batch_np.width,
    )
