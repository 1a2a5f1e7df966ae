"""Topology planner: pick a (stage, seq, frame, cfg) mesh factorization
(port of ``vdpp_tpu/parallel/topology.py``; all but
:func:`count_unet_comm_sites` is the JAX package's pure Python, copied).

The framework exposes composable mesh axes; which factorization of N
devices is best depends on the objective:

* **latency** (one sample as fast as possible): the step pipeline cannot
  shrink a single sample's wall time (its T steps are inherently
  sequential), so devices belong on the INTRA-STEP axes: CFG branch split
  (removes the 2x of sequential CFG), W-halo sequence sharding, frame
  sharding.
* **throughput** (many samples): pipeline stages scale steady-state
  linearly with a (S-1)/(N+S-1) fill bubble; intra-step axes also help but
  pay collective overhead, so stages win once the sample stream is long
  enough.

The cost model is ANALYTIC and deliberately simple: per-axis efficiency
factors are the JAX package's order-of-magnitude values (halo exchanges and
K/V gathers a few percent of a step; the CFG swap one latent). It ranks
plans; it does not promise wall-clock numbers. ``modes/production.py
--auto-topology`` applies the top plan.

The comm terms count collectives structurally (``count_unet_comm_sites`` +
``svd_step_comm_census``), per step, in the JAX package's unit, the
StableHLO op: per forward a seq axis costs 2 ppermutes per 3x3 conv, 2 K/V
all-gathers per spatial attention, 2 stat all-reduces per psum'd GroupNorm
and 1 output gather; a frame axis 2 ppermutes per temporal conv, 2 K/V
all-gathers per temporal attention, 2 all-reduces per temporal GroupNorm
and 1 output gather; a cfg axis exactly 1 latent ppermute per step.

The port's ``parallel/collectives.py`` counts calls instead
(``collectives.counts``). The two units map one to one but for the halo:

* ``collective_permute`` = 2 x ``halo`` + ``swap`` (a halo exchange is one
  call that sends both edges, the JAX package's two one-hop ppermutes; the
  cfg swap is one call and one ppermute);
* ``all_gather`` = ``all_gather`` (K, V and the output, one call each);
* ``all_reduce`` = ``mean`` (a psum'd GroupNorm takes two means, of the
  mean and of the variance, each one call).
"""

from __future__ import annotations

import math
from dataclasses import dataclass


@dataclass(frozen=True)
class CommCensus:
    """Collective-op counts of ONE pipeline step (all UNet forwards)."""

    collective_permute: int = 0
    all_gather: int = 0
    all_reduce: int = 0


def count_unet_comm_sites(model) -> dict:
    """Structural comm-site counts of an SVD UNet: the port's ``SVDUNet``
    (any device, the meta device too) or its state dict, the JAX package's
    dict of the same parameter tree.

    Walks the module paths (a state dict's names give them as the prefixes
    of its keys), so the counts track the architecture instead of
    hand-maintained constants:

    * ``st_resblock``: spatio-temporal resblocks, a module with a
      ``spatial_res_block`` and a ``temporal_res_block`` (2 spatial 3x3
      convs + 2 psum'd spatial norms + 2 temporal convs + 2 temporal norms
      each);
    * ``st_transformer``: spatio-temporal transformers, a module with a
      ``time_pos_embed`` and a ``proj_in`` (1 spatial attn, 1 temporal attn,
      1 psum'd GroupNorm each);
    * ``halo_conv``: standalone 3x3 conv sites on the halo path
      (``conv_in``, ``conv_out``, every down- and upsampler's conv).
    """
    if isinstance(model, dict):
        paths = {".".join(k.split(".")[:i]) for k in model for i in range(1, k.count(".") + 1)}
    else:
        paths = {name for name, _ in model.named_modules() if name}
    children: dict[str, set[str]] = {}
    for path in paths:
        parent, _, last = path.rpartition(".")
        children.setdefault(parent, set()).add(last)
    counts = {"st_resblock": 0, "st_transformer": 0, "halo_conv": 0}
    for parent, kids in children.items():
        if {"spatial_res_block", "temporal_res_block"} <= kids:
            counts["st_resblock"] += 1
        if {"time_pos_embed", "proj_in"} <= kids:
            counts["st_transformer"] += 1
        counts["halo_conv"] += len(kids & {"conv_in", "conv_out"})
        if parent.rpartition(".")[2] in ("downsamplers", "upsamplers"):
            counts["halo_conv"] += len(kids)
    return counts


def svd_step_comm_census(
    sites: dict,
    *,
    seq: bool = False,
    frame: bool = False,
    cfg_parallel: bool = False,
    guidance: bool = True,
) -> CommCensus:
    """Predicted collective counts of ONE compiled pipeline step.

    Derivation (per UNet forward; every psum'd GroupNorm is two pmeans —
    mean and variance — hence two all-reduces):

    * seq axis: each 3x3 spatial conv halo-exchanges one edge column in
      each direction (2 ppermutes; sites = 2 per resblock + the
      standalone halo convs); spatial attention all-gathers K and V;
      ALL GroupNorms psum their statistics over the W shard (2 per
      spatial resnet + 2 per temporal resnet + 1 per transformer + the
      head norm); the finished W shard is gathered once.
    * frame axis: each temporal conv halo-exchanges one edge frame
      (2 per resblock); temporal attention all-gathers K and V; only the
      TEMPORAL norms (2 per resblock) span frames; one output gather.
    * cfg axis: the uncond/cond branches run concurrently — one latent
      ppermute per step swaps the results; the forward itself is
      collective-free on this axis.

    CFG sequential (``guidance`` and not ``cfg_parallel``) doubles the
    per-forward counts.

    Defined (and HLO-pinned) for SINGLE intra-sample axis configs — the
    basis of the planner's per-axis discounts. Combined seq x frame
    programs merge the temporal-norm reductions into joint-group
    all-reduces, so the counts are not additive there.
    """
    n_res = sites["st_resblock"]
    n_tr = sites["st_transformer"]
    n_halo = sites["halo_conv"]
    cp = ag = ar = 0
    if seq:
        cp += 2 * (2 * n_res + n_halo)
        ag += 2 * n_tr + 1
        ar += 2 * (4 * n_res + n_tr + 1)
    if frame:
        cp += 2 * (2 * n_res)
        ag += 2 * n_tr + 1
        ar += 2 * (2 * n_res)
    forwards = 2 if (guidance and not cfg_parallel) else 1
    cp *= forwards
    ag *= forwards
    ar *= forwards
    if cfg_parallel:
        cp += 1
    return CommCensus(cp, ag, ar)


@dataclass(frozen=True)
class TopologyPlan:
    """One candidate mesh factorization with its analytic scores."""

    stage: int
    seq: int
    frame: int
    cfg: int
    devices: int
    padded_steps: int          # schedule length after stage padding
    step_speedup: float        # est. per-step latency reduction factor
    latency_rel: float         # est. single-sample latency vs 1 device (<1 is faster)
    throughput_rel: float      # est. steady throughput vs 1 device (>1 is faster)

    @property
    def axes(self) -> dict:
        """Mesh axis sizes (only the >1 axes), in canonical order."""
        out = {}
        if self.stage > 1:
            out["stage"] = self.stage
        if self.seq > 1:
            out["seq"] = self.seq
        if self.frame > 1:
            out["frame"] = self.frame
        if self.cfg > 1:
            out["cfg"] = self.cfg
        return out

    def comm_census(self, sites: dict) -> "CommCensus":
        """Per-step collective counts this plan implies for a model with
        the given ``count_unet_comm_sites`` structure — the HLO-pinned
        basis of the per-axis efficiency discounts (module docstring).
        Combined seq x frame plans report the additive upper bound (the
        compiled program merges temporal-norm reductions)."""
        return svd_step_comm_census(
            sites, seq=self.seq > 1, frame=self.frame > 1,
            cfg_parallel=self.cfg > 1,
        )

    def describe(self) -> str:
        ax = " x ".join(f"{k}={v}" for k, v in self.axes.items()) or "single-device"
        if self.latency_rel <= 1.0:
            lat = f"{1 / self.latency_rel:.2f}x faster"
        else:
            # schedule padding can make a single sample SLOWER than one
            # device; never phrase that as "0.9x faster"
            lat = f"{self.latency_rel:.2f}x slower"
        return (
            f"{ax} ({self.devices} devices): est. step speedup "
            f"{self.step_speedup:.2f}x, single-sample latency {lat}, "
            f"steady throughput {self.throughput_rel:.2f}x"
        )


def _divisors(n: int) -> list[int]:
    return [d for d in range(1, n + 1) if n % d == 0]


def plan_topology(
    n_devices: int,
    *,
    total_steps: int,
    frames: int,
    latent_w: int,
    num_samples: int = 1,
    seq_min_divisor_unit: int = 8,
    guidance: bool = True,
    objective: str = "latency",
    seq_efficiency: float = 0.85,
    frame_efficiency: float = 0.90,
    cfg_efficiency: float = 0.97,
    allow_pad_steps: bool = True,
    allow_intra_sample: bool = True,
    deepcache_interval: int = 0,
    max_plans: int = 8,
) -> list[TopologyPlan]:
    """Rank valid (stage, seq, frame, cfg) factorizations of ``n_devices``.

    Args:
        total_steps: schedule length T.
        frames: latent frame count F (frame axis must divide it).
        latent_w: latent width W (seq axis s needs
            ``W % (s * seq_min_divisor_unit) == 0``).
        num_samples: expected sample-stream length (drives the pipeline
            fill-bubble term N/(N+S-1) of the throughput score).
        seq_min_divisor_unit: ``2^(levels-1)`` of the UNet
            (``SVDUNetConfig.seq_min_divisor(s) == s * unit``; 8 for
            svd-xt's 4 levels).
        guidance: CFG active (the cfg axis is only meaningful then).
        objective: "latency" (rank by single-sample latency) or
            "throughput" (rank by steady-state samples/sec).
        *_efficiency: analytic per-doubling efficiency of each intra-step
            axis (eta(k) = eff^log2(k)): halo exchanges / K/V gathers /
            the CFG ppermute are cheap on ICI but not free.
        allow_pad_steps: stages that do not divide T are allowed by
            padding the schedule with exact-identity steps
            (``EulerKarrasSchedule.create(pad_to_multiple_of=...)``);
            the padding cost enters the scores as padded_T/T.
        allow_intra_sample: when False, only stage-axis factorizations
            are considered (seq = frame = cfg = 1) — an escape hatch for
            run modes that cannot shard within a sample. (--deepcache no
            longer needs it: since round 5 the cache lanes enter/leave
            apply_cached replicated over the intra-sample axes, so
            deepcache composes with seq/frame/cfg.)
        deepcache_interval: active DeepCache cadence (0 = off). With a
            seq or frame axis the cached/full ``lax.cond`` branches
            contain collectives, so pipelining additionally requires the
            branch predicate to be stage-invariant: steps_per_stage must
            be a multiple of the interval and the schedule unpadded
            (StepPipeline enforces this — violations would deadlock).
            Plans breaking that contract are filtered out here so
            ``--auto-topology --deepcache N`` never selects one.
            Single-stage plans are exempt (matching StepPipeline): with
            one stage every device runs the same step at every scan
            slot, so the predicate is globally uniform whatever the
            cadence or padding.

    Returns:
        Plans sorted best-first by the objective (ties: fewer devices).
    """
    if objective not in ("latency", "throughput"):
        raise ValueError(f"unknown objective {objective!r}")
    if n_devices < 1:
        raise ValueError("n_devices must be >= 1")

    def eta(k: int, eff: float) -> float:
        return eff ** math.log2(k) if k > 1 else 1.0

    plans: list[TopologyPlan] = []
    for cfg_ax in (1, 2) if (guidance and allow_intra_sample) else (1,):
        for frame_ax in _divisors(frames) if allow_intra_sample else (1,):
            for seq_ax in range(1, (n_devices if allow_intra_sample else 1) + 1):
                if seq_ax > 1 and latent_w % (seq_ax * seq_min_divisor_unit):
                    continue
                inner = cfg_ax * frame_ax * seq_ax
                if inner > n_devices:
                    continue
                # every stage count that fits (a smaller-than-maximal one
                # can win when the maximal count forces schedule padding)
                for stage_ax in range(1, n_devices // inner + 1):
                    if total_steps % stage_ax == 0:
                        padded = total_steps
                    elif allow_pad_steps:
                        padded = math.ceil(total_steps / stage_ax) * stage_ax
                    else:
                        continue
                    if (
                        deepcache_interval
                        and stage_ax > 1
                        and (seq_ax > 1 or frame_ax > 1)
                        and (
                            padded != total_steps
                            or (total_steps // stage_ax) % deepcache_interval
                        )
                    ):
                        # collective-uniformity contract (see docstring)
                        continue
                    pad_cost = padded / total_steps
                    # Per-step speedup of the intra-step axes. A cfg axis
                    # removes sequential CFG's 2nd forward entirely (2x),
                    # minus one latent ppermute.
                    speedup = (
                        seq_ax * eta(seq_ax, seq_efficiency)
                        * frame_ax * eta(frame_ax, frame_efficiency)
                        * (2.0 * eta(2, cfg_efficiency) if cfg_ax == 2 else 1.0)
                    )
                    # Single-sample latency: T sequential steps regardless
                    # of stage count (stages only add hand-offs, ~free on
                    # ICI at the measured 14500:1 compute:comm ratio).
                    latency_rel = pad_cost / speedup
                    # Steady throughput: stage_ax-way step pipelining with
                    # the exact fill bubble for num_samples.
                    fill = num_samples / (num_samples + stage_ax - 1)
                    throughput_rel = stage_ax * speedup * fill / pad_cost
                    plans.append(TopologyPlan(
                        stage=stage_ax, seq=seq_ax, frame=frame_ax,
                        cfg=cfg_ax, devices=stage_ax * inner,
                        padded_steps=padded, step_speedup=speedup,
                        latency_rel=latency_rel,
                        throughput_rel=throughput_rel,
                    ))

    key = (
        (lambda p: (p.latency_rel, p.devices))
        if objective == "latency"
        else (lambda p: (-p.throughput_rel, p.devices))
    )
    # keep the best-scored instance of each distinct factorization
    seen = set()
    unique = []
    for p in sorted(plans, key=key):
        k = (p.stage, p.seq, p.frame, p.cfg)
        if k not in seen:
            seen.add(k)
            unique.append(p)
    return unique[:max_plans]
