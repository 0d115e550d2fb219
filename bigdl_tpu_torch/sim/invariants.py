"""Fleet-level invariants — what every chaos scenario must uphold.

A scenario run produces an observation bundle (decisions with virtual
timestamps, per-host alert transitions with episode ids, per-cycle
scrape walls, the final world, sink failure counts);
:func:`check_scenario` turns it + the scenario's ``expect`` block into
a list of :class:`InvariantResult` verdicts:

* **no_flap** — the autoscaler never issues opposite-direction
  decisions inside one cooldown window, and the decision count stays
  inside the scenario's declared bounds with every required reason
  present;
* **convergence** — the run ends at the expected world, quiet through
  the declared tail;
* **exactly_once_episodes** — per (host, rule): transitions strictly
  alternate firing → resolved, episode ids are consecutive and pair
  each resolve to its firing, per-host episode counts stay in the
  declared range, and (when declared) everything is resolved by
  scenario end.  This is the invariant that pins the alert-engine
  double-fire fix;
* **conservative_degradation** — no decision lands inside a window
  where the scenario declares signals unreliable (partitions): an
  absent signal must never breach a rule;
* **scrape_budget** — no scrape cycle's wall clock exceeded the
  declared bound (the concurrent bounded-pool scrape's contract; a
  serial scrape fails this the moment peers time out);
* **sink_failures** — a poisoned alert sink is *counted*, not wedging:
  at least the declared number of delivery failures landed while the
  episode invariant above still held;
* **bundle_per_episode** — with ``BIGDL_TORCH_BUNDLE_DIR`` configured, every
  alert ``firing`` transition produced exactly ONE manifest-valid
  debug bundle (``obs/bundle.py``): none dropped, none duplicated,
  none torn.  Unconfigured runs pass with an explicit "not exercised"
  note so the scenario matrix stays runnable without a bundle dir.

Standalone probes for the properties a tick loop cannot express:

* :func:`check_aggregation_scaling` — the real
  :class:`~bigdl_tpu_torch.obs.aggregate.FleetAggregator` snapshot cost at N
  hosts stays within a wall budget AND grows ~linearly (measured
  against a fleet a quarter the size);
* :func:`check_supervisor_flap` — the real
  :class:`~bigdl_tpu_torch.resilience.supervisor.Supervisor` rides a
  flapping (preemption-class) child without spending ONE unit of the
  transient retry budget;
* :func:`check_watchdog` — the real :class:`~bigdl_tpu_torch.resilience.
  supervisor.HangWatchdog` flags a genuinely stalled host and stays
  conservative on a partitioned (unreachable) one;
* :func:`check_rollup_exactness` — the two-tier leaf->root
  :class:`~bigdl_tpu_torch.obs.rollup.RollupAggregator` merge is bit-equal
  to the flat single-tier merge (``_sum`` alone gets ulp slack) and
  derives the identical fleet p99 — the hierarchical-exactness
  invariant;
* :func:`check_rollup_bounds` — with top-K active, no family exceeds
  ``top_k + 1`` logical series, drops are counted, the node's memory
  self-gauge tracks the bound (not N), and scrape walls stay budgeted;
* :func:`check_staleness_exclusion` — skewed-clock and partitioned
  hosts are flagged stale, excluded from fleet percentiles, and
  accounted in ``bigdl_fleet_stale_hosts``.

Serving data-plane invariants (the router chaos scenarios in
:mod:`bigdl_tpu_torch.sim.serve` — :func:`check_serve_scenario` composes):

* **request_conservation** — every admitted request is answered
  exactly once (completed or an explicit shed): zero lost, zero
  duplicated across preemption dumps, drains, and handoff replays;
* **retry_amplification** — the shared retry budget's arithmetic
  bound holds (retries granted <= burst + ratio x requests) and
  end-to-end backend amplification stays <= 1 + ratio + slack — a
  brownout cannot turn into a retry storm;
* **slo_stability** — the backlog-driven SLO-burn alert fires at most
  the declared number of times and is resolved by scenario end:
  absorbing a preemption storm must not flap the alert.

Live-weight-rollout invariants (the ``weight_rollout`` scenario —
composed into :func:`check_serve_scenario` when the scenario's
``expect`` block declares rollout expectations):

* **rollback_exactly_once** — a bad canary triggers exactly the
  declared number of rollback episodes (hysteresis means one, not a
  promote/rollback flap), and the declared promotions all landed;
* **no_version_skew_after_settle** — after the run settles, every
  replica serves the expected incumbent version: no canary left
  behind, no half-promoted fleet;
* **corrupt_never_loaded** — a corrupt-mid-publish checkpoint is
  rejected by the verify-before-swap gate and reaches zero replicas;
* **zero_dropped_requests** — across promote, canary, rollback and
  the drain/handoff cycles they drive: zero lost, zero duplicated,
  zero shed.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List


@dataclasses.dataclass
class InvariantResult:
    """One invariant verdict (JSON-able via dataclasses.asdict)."""

    name: str
    ok: bool
    detail: str

    def __str__(self) -> str:
        return f"[{'PASS' if self.ok else 'FAIL'}] {self.name}: " \
               f"{self.detail}"


def _result(name: str, ok: bool, detail: str) -> InvariantResult:
    return InvariantResult(name, bool(ok), detail)


# ------------------------------------------------------------- checks
def check_no_flap(decisions: List[dict], cooldown_s: float,
                  expect: dict) -> InvariantResult:
    problems = []
    for prev, cur in zip(decisions, decisions[1:]):
        gap = cur["t"] - prev["t"]
        if cur["direction"] != prev["direction"] and gap < cooldown_s:
            problems.append(
                f"{prev['direction']}@{prev['t']:.0f}s then "
                f"{cur['direction']}@{cur['t']:.0f}s ({gap:.0f}s < "
                f"cooldown {cooldown_s:.0f}s)")
    lo = int(expect.get("min_decisions", 0))
    hi = expect.get("max_decisions")
    n = len(decisions)
    if n < lo:
        problems.append(f"only {n} decision(s), expected >= {lo}")
    if hi is not None and n > int(hi):
        problems.append(f"{n} decision(s), expected <= {hi}")
    reasons = [d["reason"] for d in decisions]
    for want in expect.get("reasons", []):
        if want not in reasons:
            problems.append(f"required reason {want!r} never decided "
                            f"(got {sorted(set(reasons))})")
    return _result(
        "no_flap", not problems,
        "; ".join(problems) or
        f"{n} decision(s), no up/down inside the "
        f"{cooldown_s:.0f}s cooldown")


def check_convergence(decisions: List[dict], final_world: int,
                      duration_s: float,
                      expect: dict) -> InvariantResult:
    problems = []
    fw = expect.get("final_world")
    if fw is not None:
        lo, hi = (fw if isinstance(fw, (list, tuple)) else (fw, fw))
        if not int(lo) <= int(final_world) <= int(hi):
            problems.append(f"final world {final_world} outside "
                            f"[{lo}, {hi}]")
    tail = expect.get("quiet_tail_s")
    if tail is not None:
        cutoff = duration_s - float(tail)
        late = [d for d in decisions if d["t"] >= cutoff]
        if late:
            problems.append(f"{len(late)} decision(s) inside the "
                            f"final {tail:.0f}s quiet tail")
    return _result("convergence", not problems,
                   "; ".join(problems) or f"settled at world "
                                          f"{final_world}")


def check_exactly_once_episodes(transitions: List[dict],
                                expect: dict) -> InvariantResult:
    """Per (host, rule): firing/resolved strictly alternate, episode
    ids are consecutive and pair each resolve with its firing — the
    'exactly once per episode' contract."""
    problems = []
    by_key: Dict[tuple, List[dict]] = {}
    for t in transitions:
        by_key.setdefault((t["host"], t["rule"]), []).append(t)
    fired_rules = set()
    episode_counts: Dict[str, List[int]] = {}
    for (host, rule), seq in sorted(by_key.items()):
        fired_rules.add(rule)
        episodes = 0
        expect_state = "firing"
        for t in seq:
            if t["state"] != expect_state:
                problems.append(
                    f"h{host}/{rule}: got {t['state']!r} where "
                    f"{expect_state!r} was due (episode "
                    f"{t.get('episode')})")
                break
            if t["state"] == "firing":
                episodes += 1
                if t.get("episode") != episodes:
                    problems.append(
                        f"h{host}/{rule}: firing #{episodes} carries "
                        f"episode id {t.get('episode')} — the same "
                        "episode fired twice or an id was skipped")
                    break
                expect_state = "resolved"
            else:
                if t.get("episode") != episodes:
                    problems.append(
                        f"h{host}/{rule}: resolve pairs episode "
                        f"{t.get('episode')} with firing {episodes}")
                    break
                expect_state = "firing"
        episode_counts.setdefault(rule, []).append(episodes)
        if expect.get("all_resolved") and seq and \
                seq[-1]["state"] != "resolved":
            problems.append(f"h{host}/{rule}: still firing at "
                            "scenario end")
    for rule, bounds in (expect.get("alert_episodes") or {}).items():
        lo, hi = (bounds if isinstance(bounds, (list, tuple))
                  else (bounds, bounds))
        for n in episode_counts.get(rule, []):
            if not int(lo) <= n <= int(hi):
                problems.append(f"{rule}: a host saw {n} episode(s), "
                                f"expected [{lo}, {hi}]")
                break
    for rule in expect.get("alerts_required", []):
        if rule not in fired_rules:
            problems.append(f"required alert {rule!r} never fired on "
                            "any host")
    n_eps = sum(sum(v) for v in episode_counts.values())
    return _result(
        "exactly_once_episodes", not problems,
        "; ".join(problems[:4]) or
        f"{n_eps} episode(s) across {len(by_key)} host-rule pairs, "
        "all paired")


def check_conservative(decisions: List[dict],
                       expect: dict) -> InvariantResult:
    windows = expect.get("no_decisions_during_s") or []
    bad = [d for d in decisions
           for a, b in windows if a <= d["t"] < b]
    return _result(
        "conservative_degradation", not bad,
        (f"{len(bad)} decision(s) inside degraded windows "
         f"{windows}: " + ", ".join(
             f"{d['reason']}@{d['t']:.0f}s" for d in bad[:4]))
        if bad else
        f"no decisions inside {len(windows)} degraded window(s)")


def check_scrape_budget(scrape_cycles: List[dict],
                        expect: dict) -> InvariantResult:
    budget = expect.get("max_scrape_cycle_s")
    if budget is None or not scrape_cycles:
        return _result("scrape_budget", True,
                       "no budget declared" if budget is None
                       else "no scrape cycles observed")
    worst = max(scrape_cycles, key=lambda c: c["wall_s"])
    mean = sum(c["wall_s"] for c in scrape_cycles) / len(scrape_cycles)
    ok = worst["wall_s"] <= float(budget)
    return _result(
        "scrape_budget", ok,
        f"worst cycle {worst['wall_s'] * 1000:.1f}ms "
        f"(mean {mean * 1000:.1f}ms, {len(scrape_cycles)} cycles, "
        f"budget {float(budget) * 1000:.0f}ms, worst had "
        f"{worst['down']} down peer(s))")


def check_sink(sink_failures: float, expect: dict) -> InvariantResult:
    need = expect.get("min_sink_failures")
    if need is None:
        return _result("sink_failures", True, "no sink expectation")
    ok = sink_failures >= int(need)
    return _result(
        "sink_failures", ok,
        f"{int(sink_failures)} failed sink delivery(ies) counted "
        f"(needed >= {need}) while the episode invariant held")


def check_bundles(observed: dict, expect: dict) -> InvariantResult:
    """With a bundle dir configured, the alert->bundle path produced
    exactly one manifest-valid debug bundle per firing transition."""
    if not expect.get("bundles_per_episode"):
        return _result("bundle_per_episode", True,
                       "no bundle expectation")
    if not observed.get("bundle_dir"):
        return _result(
            "bundle_per_episode", True,
            "BIGDL_TORCH_BUNDLE_DIR unset — bundle plane not exercised")
    episodes = sum(1 for t in observed.get("transitions", [])
                   if t.get("state") == "firing")
    bundles = observed.get("bundles") or []
    valid = [b for b in bundles if b.get("ok")]
    torn = [b for b in bundles if not b.get("ok")]
    problems = []
    if torn:
        problems.append(
            f"{len(torn)} torn/invalid bundle(s): "
            + ", ".join(f"{b['name']} ({b.get('reason')})"
                        for b in torn[:3]))
    if len(valid) != episodes:
        problems.append(
            f"{len(valid)} manifest-valid bundle(s) for {episodes} "
            "firing transition(s) — the alert->bundle path dropped or "
            "duplicated an episode (is BIGDL_TORCH_BUNDLE_RATE_LIMIT=0?)")
    return _result(
        "bundle_per_episode", not problems,
        "; ".join(problems) or
        f"{len(valid)} bundle(s), one per firing transition, all "
        "manifest-valid")


def check_scenario(observed: dict, expect: dict,
                   cooldown_s: float) -> List[InvariantResult]:
    """All applicable invariant checks over one scenario's observation
    bundle (the runner builds ``observed``)."""
    return [
        check_no_flap(observed["decisions"], cooldown_s, expect),
        check_convergence(observed["decisions"],
                          observed["final_world"],
                          observed["duration_s"], expect),
        check_exactly_once_episodes(observed["transitions"], expect),
        check_conservative(observed["decisions"], expect),
        check_scrape_budget(observed["scrape_cycles"], expect),
        check_sink(observed.get("sink_failures", 0.0), expect),
        check_bundles(observed, expect),
    ]


# --------------------------------------- serving data-plane invariants
def check_request_conservation(observed: dict,
                               expect: dict) -> InvariantResult:
    """Zero lost, zero duplicated — and every request accounted for:
    completed + shed == unique answers == requests."""
    problems = []
    lost = int(observed.get("lost", 0))
    dup = int(observed.get("duplicates", 0))
    if lost > int(expect.get("max_lost", 0)):
        problems.append(f"{lost} request(s) LOST (never answered)")
    if dup > int(expect.get("max_duplicates", 0)):
        problems.append(f"{dup} request(s) answered more than once")
    answered = observed["completed"] + observed["shed"]
    if answered + lost != observed["requests"]:
        problems.append(
            f"conservation broke: {observed['completed']} completed + "
            f"{observed['shed']} shed + {lost} lost != "
            f"{observed['requests']} requests")
    max_shed = expect.get("max_shed")
    if max_shed is not None and observed["shed"] > int(max_shed):
        problems.append(f"{observed['shed']} shed > allowed {max_shed}")
    max_late = expect.get("max_late_discarded")
    if max_late is not None and \
            observed.get("late_discarded", 0) > int(max_late):
        problems.append(f"{observed['late_discarded']} late zombie "
                        f"completion(s), allowed {max_late}")
    for key, label in (("min_handoff_replays", "handoff_replays"),
                       ("min_drains", "drains"),
                       ("min_retries", "retries")):
        need = expect.get(key)
        if need is not None and observed.get(label, 0) < int(need):
            problems.append(f"only {observed.get(label, 0)} {label}, "
                            f"scenario needs >= {need} to mean "
                            "anything")
    ledger = observed.get("ledger") or {}
    return _result(
        "request_conservation", not problems,
        "; ".join(problems) or
        f"{observed['requests']} requests -> "
        f"{observed['completed']} completed + {observed['shed']} shed, "
        f"0 lost, 0 duplicated ({observed.get('handoff_replays', 0)} "
        f"claim-gated replay(s), ledger dedup "
        f"{ledger.get('duplicates', 0)})")


def check_retry_amplification(observed: dict,
                              expect: dict) -> InvariantResult:
    """The budget's hard arithmetic (granted <= burst + ratio x
    requests) AND the end-to-end bound: backend attempts per client
    request <= 1 + ratio + slack."""
    problems = []
    b = observed["budget"]
    granted = int(b["retries_granted"])
    ceiling = float(b["burst"]) + float(b["ratio"]) * int(b["requests"])
    if granted > ceiling + 1e-9:
        problems.append(f"budget arithmetic broke: {granted} retries "
                        f"granted > burst {b['burst']:g} + "
                        f"{b['ratio']:g} x {b['requests']} requests "
                        f"= {ceiling:g}")
    slack = float(expect.get("amplification_slack", 0.05))
    bound = 1.0 + float(b["ratio"]) + slack
    amp = float(observed["amplification"])
    if amp > bound:
        problems.append(f"amplification {amp:.3f} > 1 + ratio "
                        f"{b['ratio']:g} + slack {slack:g} = "
                        f"{bound:.3f}")
    return _result(
        "retry_amplification", not problems,
        "; ".join(problems) or
        f"amplification {amp:.3f} <= {bound:.3f} "
        f"({granted} retries granted, {b['retries_denied']} denied, "
        f"ceiling {ceiling:.0f})")


def check_slo_stability(observed: dict,
                        expect: dict) -> InvariantResult:
    """The SLO-burn alert fires at most the declared number of times
    (default 1 — once for the incident) and is quiet by the end."""
    problems = []
    flaps = int(observed.get("slo_flaps", 0))
    max_flaps = int(expect.get("max_slo_flaps", 1))
    if flaps > max_flaps:
        problems.append(f"SLO-burn alert fired {flaps}x "
                        f"(allowed {max_flaps}) — flapping")
    if expect.get("slo_resolved", True) and \
            observed.get("slo_firing_at_end"):
        problems.append("SLO-burn alert still firing at scenario end")
    return _result(
        "slo_stability", not problems,
        "; ".join(problems) or
        f"{flaps} firing(s), resolved by scenario end")


def check_rollback_exactly_once(observed: dict,
                                expect: dict) -> InvariantResult:
    """A bad canary rolls back exactly the declared number of times —
    hysteresis means one decisive episode, never a promote/rollback
    flap — and the declared promotions all happened, in order."""
    problems = []
    want = int(expect.get("rollbacks", 0))
    got = int(observed.get("rollbacks", 0))
    if got != want:
        problems.append(f"{got} rollback episode(s), expected exactly "
                        f"{want}")
    promos = expect.get("promotions")
    if promos is not None and \
            list(observed.get("promotions") or []) != list(promos):
        problems.append(f"promotions {observed.get('promotions')} != "
                        f"expected {list(promos)}")
    state = observed.get("rollout_state")
    if state not in (None, "idle"):
        problems.append(f"controller still {state!r} at scenario end")
    return _result(
        "rollback_exactly_once", not problems,
        "; ".join(problems) or
        f"{got} rollback(s), promotions "
        f"{observed.get('promotions')}, controller idle")


def check_no_version_skew(observed: dict,
                          expect: dict) -> InvariantResult:
    """After the run settles every replica serves one version — the
    expected one when declared.  A canary left behind or a
    half-promoted fleet is exactly the skew the rollout tier exists to
    prevent."""
    problems = []
    versions = observed.get("versions_at_end") or {}
    distinct = sorted(set(versions.values()))
    if len(distinct) > 1:
        problems.append(f"fleet did not converge: {distinct} "
                        f"({versions})")
    settle = expect.get("settle_version")
    if settle is not None:
        skewed = sorted(n for n, v in versions.items() if v != settle)
        if skewed:
            problems.append(f"{skewed} not on expected {settle!r} "
                            f"({versions})")
    return _result(
        "no_version_skew_after_settle", not problems,
        "; ".join(problems) or
        f"all {len(versions)} replica(s) on "
        f"{distinct[0] if distinct else '?'}")


def check_corrupt_never_loaded(observed: dict,
                               expect: dict) -> InvariantResult:
    """The verify-before-swap gate held: every corrupt-mid-publish
    checkpoint was rejected, and none reached a replica."""
    problems = []
    need = int(expect.get("min_corrupt_rejected", 0))
    rejected = int(observed.get("corrupt_rejected", 0))
    if rejected < need:
        problems.append(f"only {rejected} corrupt publish(es) "
                        f"rejected, scenario injects >= {need}")
    loaded = int(observed.get("corrupt_loaded", 0))
    if loaded > 0:
        problems.append(f"{loaded} corrupt publish(es) REACHED a "
                        "replica — the verify gate is porous")
    return _result(
        "corrupt_never_loaded", not problems,
        "; ".join(problems) or
        f"{rejected} corrupt publish(es) rejected, 0 loaded")


def check_zero_dropped(observed: dict) -> InvariantResult:
    """The rollout path's hard conservation bar: promote, canary and
    rollback (with their drain/handoff cycles) drop NOTHING — zero
    lost, zero duplicated, zero shed."""
    problems = []
    for key in ("lost", "duplicates", "shed"):
        n = int(observed.get(key, 0))
        if n > 0:
            problems.append(f"{n} request(s) {key}")
    return _result(
        "zero_dropped_requests", not problems,
        "; ".join(problems) or
        f"{observed.get('requests', 0)} requests, 0 lost / 0 dup / "
        "0 shed across the rollout cycle")


def check_serve_scenario(observed: dict,
                         expect: dict) -> List[InvariantResult]:
    """All serving data-plane invariants over one scenario's
    observation bundle (:func:`bigdl_tpu_torch.sim.serve.run_serve_scenario`
    builds ``observed``).  Rollout invariants join the list when the
    scenario declares rollout expectations."""
    out = [
        check_request_conservation(observed, expect),
        check_retry_amplification(observed, expect),
        check_slo_stability(observed, expect),
    ]
    if "rollbacks" in expect or "settle_version" in expect:
        out += [
            check_rollback_exactly_once(observed, expect),
            check_no_version_skew(observed, expect),
            check_corrupt_never_loaded(observed, expect),
            check_zero_dropped(observed),
        ]
    return out


# -------------------------------------------------- standalone probes
def check_aggregation_scaling(n_hosts: int, budget_s: float,
                              seed: int = 0, cycles: int = 3,
                              ratio_slack: float = 3.0
                              ) -> InvariantResult:
    """The real ``FleetAggregator.snapshot()`` over a fully healthy
    fleet of ``n_hosts`` must finish inside ``budget_s`` AND scale
    ~linearly: against a fleet a quarter the size, the cost ratio may
    not exceed the host ratio times ``ratio_slack`` (a quadratic
    aggregation blows this immediately)."""
    from bigdl_tpu_torch.obs.aggregate import FleetAggregator
    from bigdl_tpu_torch.sim.clock import VirtualClock
    from bigdl_tpu_torch.sim.fleet import SimFleet

    def cycle_wall(n: int) -> float:
        clock = VirtualClock()
        fleet = SimFleet(n, clock, seed=seed)
        fleet.tick(1.0)
        agg = FleetAggregator(peers=fleet.addrs, fetch=fleet.fetch)
        best = float("inf")
        for _ in range(max(1, int(cycles))):
            t0 = time.perf_counter()
            snap = agg.snapshot()
            best = min(best, time.perf_counter() - t0)
            assert len(snap["hosts"]) == n, "snapshot dropped hosts"
        return best

    n_small = max(8, int(n_hosts) // 4)
    small = cycle_wall(n_small)
    full = cycle_wall(int(n_hosts))
    host_ratio = n_hosts / n_small
    grew = full / max(1e-9, small)
    ok = full <= float(budget_s) and grew <= host_ratio * ratio_slack
    return _result(
        "aggregation_scaling", ok,
        f"{n_hosts} hosts in {full * 1000:.1f}ms (budget "
        f"{budget_s * 1000:.0f}ms); vs {n_small} hosts "
        f"{small * 1000:.1f}ms -> grew {grew:.1f}x for {host_ratio:.1f}x "
        f"hosts (slack {ratio_slack:g}x)")


_ROLLUP_SELF = ("bigdl_rollup_", "bigdl_fleet_")


def _flat_merge(fleet, stale_after_s: float):
    """The single-tier reference: one flat ``FleetAggregator`` scrape
    over every host, live (ok and not stale) expositions policy-merged
    in one step.  Returns ``(merged_doc, stale_map, wall_s)``."""
    from bigdl_tpu_torch.obs.aggregate import FleetAggregator
    from bigdl_tpu_torch.obs.rollup import merge_parsed

    agg = FleetAggregator(peers=fleet.addrs, fetch=fleet.fetch,
                          stale_after_s=stale_after_s,
                          clock=fleet.clock.now)
    scraped = agg.scrape_peers(agg.peers)
    live = [p.get("metrics") for p in scraped
            if p.get("ok") and not p.get("stale")]
    return merge_parsed(live), dict(agg.last_stale), agg.last_scrape_s


def _comparable(doc: dict) -> dict:
    """Merged samples keyed ``(name, sorted labels)``, with the rollup
    pipeline's own self-metrics (``bigdl_rollup_*``/``bigdl_fleet_*``)
    filtered out — those exist only in the hierarchical plane."""
    out = {}
    for s in doc.get("samples") or []:
        if s["name"].startswith(_ROLLUP_SELF):
            continue
        out[(s["name"], tuple(sorted((s.get("labels") or {}).items())))] \
            = float(s["value"])
    return out


def check_rollup_exactness(n_hosts: int = 40, shard_size: int = 8,
                           seed: int = 0,
                           stale_after_s: float = 30.0
                           ) -> InvariantResult:
    """Hierarchical merge == flat merge, **bit-equal**: the two-tier
    leaf->root pipeline over the same live hosts must reproduce every
    counter, gauge, ``_bucket`` and ``_count`` sample of the flat
    single-tier merge exactly, and the fleet p99 derived from merged
    cumulative buckets must be identical.  The float ``_sum`` sample
    alone is allowed its last ulp (float addition is not associative
    across tiers; quantiles never read it)."""
    from bigdl_tpu_torch.obs import names
    from bigdl_tpu_torch.obs.rollup import build_tiers, fleet_quantile
    from bigdl_tpu_torch.sim.clock import VirtualClock
    from bigdl_tpu_torch.sim.fleet import SimFleet

    clock = VirtualClock()
    fleet = SimFleet(int(n_hosts), clock, seed=seed)
    fleet.tick(1.0)
    flat_doc, _, _ = _flat_merge(fleet, stale_after_s)
    root, leaves = build_tiers(
        fleet.addrs, fleet.fetch, shard_size=int(shard_size),
        top_k=0, stale_after_s=stale_after_s, clock=clock.now)
    hier_doc = root.refresh()

    flat, hier = _comparable(flat_doc), _comparable(hier_doc)
    problems = []
    if set(flat) != set(hier):
        only_flat = sorted(set(flat) - set(hier))[:3]
        only_hier = sorted(set(hier) - set(flat))[:3]
        problems.append(f"series sets differ: flat-only {only_flat}, "
                        f"hier-only {only_hier}")
    mismatched = 0
    for key in sorted(set(flat) & set(hier)):
        a, b = flat[key], hier[key]
        if key[0].endswith("_sum"):
            if abs(a - b) > 1e-9 * max(1.0, abs(a)):
                mismatched += 1
                problems.append(f"{key[0]}{dict(key[1])}: flat {a!r} "
                                f"vs hier {b!r} beyond _sum ulp slack")
        elif a != b:
            mismatched += 1
            problems.append(f"{key[0]}{dict(key[1])}: flat {a!r} != "
                            f"hier {b!r} (bit-equality required)")
        if mismatched >= 3:
            break
    p99_flat = fleet_quantile(flat_doc, names.REQUEST_LATENCY_SECONDS,
                              0.99, kind="e2e")
    p99_hier = fleet_quantile(hier_doc, names.REQUEST_LATENCY_SECONDS,
                              0.99, kind="e2e")
    if p99_flat is None or p99_flat != p99_hier:
        problems.append(f"fleet p99 diverged: flat {p99_flat} vs "
                        f"hier {p99_hier}")
    return _result(
        "rollup_exactness", not problems,
        "; ".join(problems[:4]) or
        f"{len(flat)} series bit-equal across {len(leaves)} leaf "
        f"shard(s) of {shard_size} (fleet p99 {p99_flat}s both ways)")


def check_rollup_bounds(n_hosts: int = 64, shard_size: int = 8,
                        top_k: int = 8, budget_s: float = 30.0,
                        seed: int = 0) -> InvariantResult:
    """The cardinality bound holds under load: with ``top_k`` active,
    no family in the root merge tracks more than ``top_k + 1`` logical
    series (the +1 is the ``other`` fold bucket), every drop is counted
    in ``bigdl_rollup_series_dropped_total``, the node's self-scraped
    memory estimate stays proportional to the bound (not to N hosts),
    and the scrape wall stays inside ``budget_s``."""
    from bigdl_tpu_torch.obs import names
    from bigdl_tpu_torch.obs.metrics import _base_family, parse_prometheus
    from bigdl_tpu_torch.obs.rollup import build_tiers
    from bigdl_tpu_torch.sim.clock import VirtualClock
    from bigdl_tpu_torch.sim.fleet import SimFleet

    clock = VirtualClock()
    fleet = SimFleet(int(n_hosts), clock, seed=seed)
    fleet.tick(1.0)
    root, leaves = build_tiers(
        fleet.addrs, fleet.fetch, shard_size=int(shard_size),
        top_k=int(top_k), clock=clock.now)
    merged = root.refresh()

    problems = []
    families = merged.get("families") or {}
    per_family: Dict[str, set] = {}
    for s in merged.get("samples") or []:
        base = _base_family(s["name"], families)
        skey = tuple(sorted((k, v) for k, v in
                            (s.get("labels") or {}).items() if k != "le"))
        per_family.setdefault(base, set()).add(skey)
    worst_fam, worst_n = "", 0
    for fam, series in per_family.items():
        if len(series) > worst_n:
            worst_fam, worst_n = fam, len(series)
        if len(series) > int(top_k) + 1:
            problems.append(f"{fam} tracks {len(series)} logical "
                            f"series > top_k {top_k} + other")
    self_doc = parse_prometheus(root.registry.to_prometheus())
    by_name: Dict[str, float] = {}
    for s in self_doc["samples"]:
        by_name[s["name"]] = by_name.get(s["name"], 0.0) + s["value"]
    dropped = by_name.get(names.ROLLUP_SERIES_DROPPED_TOTAL, 0.0)
    leaf_dropped = sum(
        v for leaf in leaves
        for s in parse_prometheus(leaf.registry.to_prometheus())["samples"]
        if s["name"] == names.ROLLUP_SERIES_DROPPED_TOTAL
        for v in [s["value"]])
    if int(n_hosts) > int(top_k) and dropped + leaf_dropped <= 0:
        problems.append("per-host cardinality exceeded top_k but "
                        "bigdl_rollup_series_dropped_total never moved")
    tracked = by_name.get(names.ROLLUP_SERIES_TRACKED)
    if tracked != len(merged["samples"]):
        problems.append(f"self-scrape tracked {tracked} != merged "
                        f"{len(merged['samples'])} samples")
    mem = by_name.get(names.ROLLUP_MEMORY_BYTES, 0.0)
    mem_cap = 512.0 * max(1, len(merged["samples"]))
    if not 0 < mem <= mem_cap:
        problems.append(f"memory self-gauge {mem:.0f}B outside "
                        f"(0, {mem_cap:.0f}B]")
    walls = [leaf.last_scrape_s or 0.0 for leaf in leaves] + \
        [root.last_scrape_s or 0.0]
    if max(walls) > float(budget_s):
        problems.append(f"scrape wall {max(walls):.2f}s > budget "
                        f"{budget_s:g}s")
    return _result(
        "rollup_bounds", not problems,
        "; ".join(problems[:4]) or
        f"{n_hosts} hosts -> {len(merged['samples'])} tracked samples "
        f"(worst family {worst_fam} at {worst_n} <= top_k {top_k}+1, "
        f"{int(dropped + leaf_dropped)} drop(s) counted, "
        f"mem {mem:.0f}B, worst wall {max(walls) * 1000:.1f}ms)")


def check_staleness_exclusion(n_hosts: int = 16, skew_id: int = 3,
                              partition_id: int = 5, seed: int = 0,
                              stale_after_s: float = 30.0
                              ) -> InvariantResult:
    """A skewed-clock host and a partitioned host are flagged stale,
    **excluded** from the merge (their series never fold into fleet
    percentiles) and **accounted** (the stale map and the
    ``bigdl_fleet_stale_hosts`` gauge both carry them), while the fleet
    p99 still derives from the live remainder."""
    from bigdl_tpu_torch.obs import names
    from bigdl_tpu_torch.obs.metrics import parse_prometheus
    from bigdl_tpu_torch.obs.rollup import build_tiers, fleet_quantile
    from bigdl_tpu_torch.sim.clock import VirtualClock
    from bigdl_tpu_torch.sim.fleet import SimFleet

    clock = VirtualClock()
    fleet = SimFleet(int(n_hosts), clock, seed=seed)
    fleet.tick(1.0)
    fleet.skew_clock(skew_id, 10.0 * float(stale_after_s))
    fleet.partition(partition_id)
    skew_addr = f"sim{int(skew_id)}:9000"
    part_addr = f"sim{int(partition_id)}:9000"

    flat_doc, stale, _ = _flat_merge(fleet, stale_after_s)
    root, leaves = build_tiers(
        fleet.addrs, fleet.fetch, top_k=0,
        stale_after_s=stale_after_s, clock=clock.now)
    root.refresh()
    fleet.partition(partition_id, on=False)

    problems = []
    if "skew" not in str(stale.get(skew_addr, "")):
        problems.append(f"skewed host {skew_addr} not flagged stale "
                        f"(stale map: {stale})")
    if part_addr not in stale:
        problems.append(f"partitioned host {part_addr} not flagged "
                        f"stale (stale map: {stale})")
    leaf_stale = {}
    for leaf in leaves:
        leaf_stale.update(leaf.stale)
    for addr in (skew_addr, part_addr):
        if addr not in leaf_stale:
            problems.append(f"hierarchical tier missed stale {addr}")
    # exclusion: the skewed host's per-host series must not appear
    host_key = str(int(skew_id))
    leaked = [s for s in flat_doc.get("samples") or []
              if (s.get("labels") or {}).get("host") == host_key]
    if leaked:
        problems.append(f"{len(leaked)} series from stale {skew_addr} "
                        "leaked into the merge")
    # accounting: the gauge on the root node carries the leaf counts
    gauge = sum(
        s["value"]
        for leaf in leaves
        for s in parse_prometheus(leaf.registry.to_prometheus())["samples"]
        if s["name"] == names.FLEET_STALE_HOSTS)
    if int(gauge) != len(leaf_stale):
        problems.append(f"bigdl_fleet_stale_hosts sums to {gauge:g}, "
                        f"stale map has {len(leaf_stale)}")
    p99 = fleet_quantile(flat_doc, names.REQUEST_LATENCY_SECONDS,
                         0.99, kind="e2e")
    if p99 is None:
        problems.append("fleet p99 vanished — live remainder lost")
    return _result(
        "staleness_exclusion", not problems,
        "; ".join(problems[:4]) or
        f"{len(stale)}/{n_hosts} host(s) stale "
        f"({', '.join(sorted(stale))}), excluded and accounted; fleet "
        f"p99 {p99}s from the {n_hosts - len(stale)} live host(s)")


def check_supervisor_flap(flaps: int = 6,
                          max_retries: int = 3) -> InvariantResult:
    """A flapping child that exits the graceful-preemption way every
    time must ride the supervisor's free preemption path: zero
    transient retry budget spent, no give-up."""
    from bigdl_tpu_torch.resilience.elastic import EXIT_PREEMPTED
    from bigdl_tpu_torch.resilience.supervisor import Supervisor
    from bigdl_tpu_torch.sim.clock import VirtualClock

    clock = VirtualClock()
    seen = {"launches": 0}

    def runner(cmd, env):
        seen["launches"] += 1
        clock.advance(30.0)  # the child "ran" half a virtual minute
        return EXIT_PREEMPTED if seen["launches"] <= int(flaps) else 0

    sup = Supervisor(["sim-flapping-child"], max_retries=max_retries,
                     runner=runner, sleep=clock.sleep)
    rc = sup.run()
    spent = sup.policy.attempts
    ok = rc == 0 and spent == 0 and sup.preemptions == int(flaps)
    return _result(
        "supervisor_retry_budget", ok,
        f"{flaps} flap(s) restarted free (rc {rc}, retry budget spent "
        f"{spent}/{max_retries}, preemptions {sup.preemptions}, "
        f"virtual wall {clock.now():.0f}s)")


def check_watchdog(fleet, stalled_id: int, partitioned_id: int,
                   timeout_s: float = 10.0,
                   hang_age_s: float = 60.0) -> InvariantResult:
    """The hang watchdog must flag a host whose step stamp stopped
    (positive evidence) and read an unreachable one as 'cannot tell',
    never as hung."""
    from bigdl_tpu_torch.resilience.supervisor import HangWatchdog

    fleet.tick(1.0)  # make sure a first step stamp exists
    stalled_host = fleet.hosts[stalled_id]
    stalled_host.stalled = True
    fleet.clock.advance(hang_age_s)
    fleet.tick(0.0)
    fleet.hosts[partitioned_id].partitioned = True
    wd_stalled = HangWatchdog(timeout_s, port=9000,
                              fetch=fleet.watchdog_fetch(stalled_id))
    wd_part = HangWatchdog(timeout_s, port=9000,
                           fetch=fleet.watchdog_fetch(partitioned_id))
    saw_stall = wd_stalled.stalled()
    saw_part = wd_part.stalled()
    stalled_host.stalled = False
    fleet.hosts[partitioned_id].partitioned = False
    ok = saw_stall and not saw_part
    return _result(
        "watchdog_classification", ok,
        f"stalled host flagged={saw_stall} (age "
        f"{stalled_host.step_age_s()}s > {timeout_s:g}s), partitioned "
        f"host conservatively not-hung={not saw_part}")
