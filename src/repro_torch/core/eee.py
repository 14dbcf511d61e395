"""EEE link power states, power-management policies, and the system power
model (paper §2.4, §3.1, Tables 3/5/6)."""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass


@dataclass(frozen=True)
class LinkState:
    """One EEE low-power state (transition targets; Wake is implicit)."""
    name: str
    t_w: float            # transition sleep -> wake (s)
    t_s: float            # transition wake -> sleep (s)
    power_frac: float     # link power in this state / wake power

    def __post_init__(self):
        # power_frac == 0 is a true off state (beyond 802.3bj, but the
        # FSM lowers it like any other row); >= 1 would never save energy
        assert self.t_w > 0 and self.t_s > 0 and 0 <= self.power_frac < 1


# Table 6 values (derived from EEE / 802.3bj, Table 3)
FAST_WAKE = LinkState("fast_wake", t_w=375e-9, t_s=200e-9, power_frac=0.4)
DEEP_SLEEP = LinkState("deep_sleep", t_w=4.48e-6, t_s=2e-6, power_frac=0.1)
EEE_STATES = {"fast_wake": FAST_WAKE, "deep_sleep": DEEP_SLEEP}


@dataclass(frozen=True)
class Policy:
    """Power-down policy for every port in the network.

    kind:
      * ``none``       — links always awake (baseline; t_PDT = inf).
      * ``fixed``      — constant ``t_pdt`` on every port (§2.5, PDT).
      * ``perfbound``  — per-port adaptive t_PDT from the inactivity
                         histogram, degradation bound ``bound`` (§2.5 [28]).
      * ``perfbound_correct`` — PerfBound + miss-ratio corrective factor
                         (§3.4, the paper's contribution).
      * ``dual``       — two-level sleep ladder (DESIGN.md §6): fixed
                         ``t_pdt`` drops the port into ``sleep_state``
                         (Fast Wake), a second timer ``t_dst`` demotes it
                         to ``deep_state`` (Deep Sleep).
      * ``coalesce``   — the dual ladder plus frame coalescing: the frame
                         that would wake a sleeping port is held up to
                         ``max_delay`` (early release once ~``max_frames``
                         frames queue), so the port sleeps through bursts.
      * ``perfbound_dual`` — the paper-enhancement ladder: PerfBound
                         drives t_PDT as usual AND selects the per-port
                         demotion threshold from the same histograms, so
                         deep sleep engages only where the predicted
                         residual idle amortizes its extra wake penalty.
      * ``precoalesce``  — hold-at-source coalescing (arXiv 2005.13267):
                         the dual ladder, but the deferral happens at the
                         INJECTION link only — frames queue at the source
                         for up to ``hold_delay`` (early release once
                         ~``hold_frames`` queue), so every downstream port
                         sees pre-formed bursts and sleeps undisturbed.
      * ``predict``      — proactive forecaster (arXiv 1503.02843): an
                         EWMA over the per-port inactivity histograms —
                         with a dominant-mode (periodogram) override for
                         periodic BSP traffic — predicts the NEXT gap and
                         schedules t_PDT and the demotion timer ahead of
                         it: a predicted-long gap sleeps/demotes at onset,
                         a predicted-short gap holds the port awake.
    hist_mode: ``keep_all`` | ``self_clear`` | ``circular`` (§3.2/§4).
    """
    kind: str = "none"
    sleep_state: str = "deep_sleep"
    t_pdt: float = 0.0
    bound: float = 0.01
    # -- dual-mode sleep ladder (dual / coalesce / perfbound_dual) ---------
    deep_state: str = "deep_sleep"    # second FSM row (lowers to numbers)
    t_dst: float = 1e-3               # demotion timer after sleep onset (s);
    #                                   perfbound_dual: initial threshold
    # -- frame coalescing (kind == "coalesce") -----------------------------
    max_delay: float = 0.0            # max wake deferral per sleep cycle (s)
    max_frames: int = 32              # queue bound: est. early-wake trigger
    # -- hold-at-source pre-coalescing (kind == "precoalesce") -------------
    hold_delay: float = 0.0           # max injection hold per sleep cycle (s)
    hold_frames: int = 32             # source queue bound: early release
    # -- arrival forecasting (kind == "predict") ---------------------------
    forecast_weight: float = 0.5      # EWMA weight of the newest gap (0=off)
    forecast_margin: float = 2.0      # safety factor on the break-even gaps
    period_conf: float = 0.6          # mode-bin share that flips to periodic
    hist_mode: str = "keep_all"
    hist_bins: int = 200
    hist_bin_width: float = 10e-6     # seconds/bin (linear binning)
    hist_log_bins: bool = False       # beyond-paper: log-spaced bins
    hist_log_min: float = 1e-7        # first log-bin edge (s)
    hist_log_max: float = 10.0        # last log-bin edge (s)
    hist_clear_n: int = 250           # self_clear: reset period (samples)
    ring_n: int = 250                 # circular: ring capacity
    # beyond-paper (the paper's §5 future-work question): exponential
    # recency bias — every insert first scales the port's histogram by
    # ``hist_decay`` (1.0 = off, paper-faithful).  keep_all mode only.
    hist_decay: float = 1.0
    n_r: int = 32                     # PBC shift-register length (<= 32)
    max_tpdt: float = 10e-3           # PBC cap; also no-feasible-bin fallback
    tpdt_init: float = 10e-3          # prediction before history forms
    sync_overhead: float = 5e-9       # §3.1 port-pair sync message cost
    cf_mode: str = "uplift"           # 'uplift': t*(1+cf) | 'scale': t*max(cf,1)
    record_hist: bool = False         # record gaps even for none/fixed (Fig 1)

    def __post_init__(self):
        assert self.kind in ("none", "fixed", "perfbound", "perfbound_correct",
                             "dual", "coalesce", "perfbound_dual",
                             "precoalesce", "predict")
        assert self.sleep_state in EEE_STATES
        assert self.deep_state in EEE_STATES
        assert self.hist_mode in ("keep_all", "self_clear", "circular")
        assert 1 <= self.n_r <= 32
        assert 0.0 < self.hist_decay <= 1.0
        assert self.hist_decay == 1.0 or self.hist_mode == "keep_all", \
            "recency decay composes with keep_all histograms only"
        if self.dual_capable:
            # the ladder must descend: the deep row may only trade a longer
            # wake for a lower power floor
            assert self.deep.t_w >= self.state.t_w \
                and self.deep.power_frac <= self.state.power_frac, \
                "deep_state must not dominate sleep_state"
            assert self.t_dst >= 0.0
        assert self.max_delay >= 0.0 and self.max_frames >= 1
        assert self.hold_delay >= 0.0 and self.hold_frames >= 1
        assert 0.0 <= self.forecast_weight <= 1.0
        assert self.forecast_margin > 0.0
        assert 0.0 < self.period_conf <= 1.0

    @property
    def state(self) -> LinkState:
        return EEE_STATES[self.sleep_state]

    @property
    def deep(self) -> LinkState:
        """The demotion target row (unreachable for single-state kinds)."""
        return EEE_STATES[self.deep_state]

    @property
    def adaptive(self) -> bool:
        return self.kind in ("perfbound", "perfbound_correct",
                             "perfbound_dual", "predict")

    @property
    def dual_capable(self) -> bool:
        """Kinds whose FSM can reach the deep row (second sleep state)."""
        return self.kind in ("dual", "coalesce", "perfbound_dual",
                             "precoalesce", "predict")


# ---------------------------------------------------------------------------
# Static-structure / numeric-parameter split (the batched-sweep contract)
# ---------------------------------------------------------------------------
#
# A Policy factors into
#   * STATIC structure — fields that change compiled code: predictor kind,
#     histogram management mode, array sizes, and boolean feature flags.
#     Policies sharing a static key can run side by side in one batched
#     replay program.
#   * NUMERIC parameters — plain floats the compiled code reads from a
#     parameter vector: timers, bounds, transition times, bin geometry.
#     ``sleep_state`` deliberately lowers to numbers (t_w/t_s/power_frac) —
#     and ``deep_state`` to (t_w2/t_s2/power_frac2), the second row of the
#     FSM state table — so Fast Wake / Deep Sleep / ladder variants of one
#     kind batch together.

# Policy fields that lower to derived numerics rather than appearing in the
# parameter vector under their own name (see policy_params)
_STATE_TABLE_FIELDS = ("t_w", "t_s", "power_frac",
                       "t_w2", "t_s2", "power_frac2")
_LOWERED_FIELDS = ("sleep_state", "deep_state")

PARAM_FIELDS = (
    "t_pdt", "tpdt_init", "max_tpdt", "bound", "sync_overhead",
    "t_w", "t_s", "power_frac",
    "t_w2", "t_s2", "power_frac2", "t_dst",
    "max_delay", "max_frames", "hold_delay", "hold_frames",
    "forecast_weight", "forecast_margin", "period_conf",
    "hist_bin_width", "hist_log_min", "hist_log_max", "hist_clear_n",
    "hist_decay",
)

STATIC_FIELDS = ("kind", "hist_mode", "hist_bins", "hist_log_bins",
                 "ring_n", "n_r", "cf_mode", "record_hist")

# every Policy field must be classified as numeric param, static structure,
# or a state-table name (sleep_state/deep_state, which lower to the
# t_w*/t_s*/power_frac* params) — a field in neither set would be silently
# shared across batch lanes
assert (set(PARAM_FIELDS) - set(_STATE_TABLE_FIELDS)) \
    | set(STATIC_FIELDS) | set(_LOWERED_FIELDS) \
    == {f.name for f in dataclasses.fields(Policy)}, \
    "new Policy field not classified in PARAM_FIELDS/STATIC_FIELDS"


def policy_params(policy: Policy) -> dict:
    """The policy's numeric parameter vector as a plain float dict.

    Passing these back into the simulator/predictor functions reproduces the
    policy exactly; stacking several dicts along a leading axis drives the
    batched sweep.  The FSM state table lowers here: row 1 (t_w/t_s/
    power_frac) from ``sleep_state``, row 2 (t_w2/t_s2/power_frac2) from
    ``deep_state``, and ``t_dst`` pins to +inf for single-state kinds so
    the deep row is numerically unreachable.
    """
    st, st2 = policy.state, policy.deep
    out = {f: float(getattr(policy, f)) for f in PARAM_FIELDS
           if f not in _STATE_TABLE_FIELDS and f != "t_dst"}
    out["t_w"] = st.t_w
    out["t_s"] = st.t_s
    out["power_frac"] = st.power_frac
    out["t_w2"] = st2.t_w
    out["t_s2"] = st2.t_s
    out["power_frac2"] = st2.power_frac
    out["t_dst"] = float(policy.t_dst) if policy.dual_capable \
        else float("inf")
    return out


def static_key(policy: Policy) -> tuple:
    """Hashable static-structure key: policies with equal keys compile to
    the same batched program (numeric params become vector lanes).

    ``hist_decay`` contributes only a boolean (the decay multiply is a
    different program, but its rate is numeric).
    """
    return tuple(getattr(policy, f) for f in STATIC_FIELDS) + \
        (policy.hist_decay < 1.0,)


def canonical_proto(policy: Policy) -> Policy:
    """Reset every numeric field to a fixed value, keeping only static
    structure (plus the ``hist_decay < 1`` program flag).

    The canonical proto is the compile-cache key of the plan executor and
    the batched sweep: policies from the same static group — and chunk
    splits of one group — hash equal, so they reuse ONE compiled program
    and read their numerics lane-wise from a parameter vector.
    """
    return dataclasses.replace(
        policy, sleep_state="deep_sleep", deep_state="deep_sleep",
        t_pdt=0.0, bound=0.01, t_dst=1e-3, max_delay=0.0, max_frames=32,
        hold_delay=0.0, hold_frames=32,
        forecast_weight=0.5, forecast_margin=2.0, period_conf=0.6,
        tpdt_init=10e-3, max_tpdt=10e-3, sync_overhead=5e-9,
        hist_bin_width=10e-6, hist_log_min=1e-7, hist_log_max=10.0,
        hist_clear_n=250,
        hist_decay=0.5 if policy.hist_decay < 1.0 else 1.0)


@dataclass(frozen=True)
class PowerModel:
    """Table 5: system power inventory (W) + link bandwidth."""
    switch_power: float = 250.0
    node_power_min: float = 800.0
    node_power_max: float = 1200.0
    port_power: float = 24.0          # per port-end at Wake
    link_bandwidth: float = 50e9      # bytes/s (400 Gb/s)
    switch_latency: float = 300e-9    # per-hop cut-through latency (s)

    def static_table(self, topo):
        """Reproduces Table 5/6 percentages for a topology.

        Following the paper's convention, each row holds the links AT the
        state's power level while nodes swing between min (idle) and max
        (full load) — i.e. the state's best-case network share bound.
        """
        sw = self.switch_power * topo.n_switches
        links_max = self.port_power * topo.n_ports
        nodes_min = self.node_power_min * topo.n_nodes
        nodes_max = self.node_power_max * topo.n_nodes
        out = {}
        for state_name, frac in [("wake", 1.0)] + [
                (s.name, s.power_frac) for s in EEE_STATES.values()]:
            links_s = links_max * frac
            idle_total = sw + nodes_min + links_s
            full_total = sw + nodes_max + links_s
            out[state_name] = {
                "links_power_idle_W": links_s,
                "network_power_idle_W": sw + links_s,
                "network_of_total_idle": (sw + links_s) / idle_total,
                "network_of_total_full": (sw + links_s) / full_total,
                "links_of_total_idle": links_s / idle_total,
                # the paper's constant 8.68 % column: links all awake under
                # full load, as a share of the full-load system
                "links_of_total_full": links_max
                / (sw + nodes_max + links_max),
                "system_idle_W": idle_total,
                "system_full_W": full_total,
            }
        return out
