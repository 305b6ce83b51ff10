"""Locality-aware placement & load balancing (paper §5.1, App-E).

Capacity model: node i at time t has residual capacity
    RC_{i,t} = MC_i − k_{i,t}·E_{i,t}
with MC_i measured offline (App-E: raise the arrival rate until E_i
inflects; MC = k'·E'), k the arrival rate and E the mean aggregation
execution time (both fed by the sidecar metrics).

Load balancing = bin packing of client updates onto the fewest nodes
within residual capacity.  BestFit (the paper's choice) concentrates
load to maximize shared-memory locality; WorstFit reproduces Knative's
"Least Connection" spreading (the SL-H baseline); FirstFit trades
locality for O(1) search.

The placement's output is reified as a :class:`FoldPlan` — an explicit,
serializable tree of fold sites that the round driver *interprets*
instead of hard-coding where the top fold runs.  Each site binds an
aggregator id to a node and a runtime tier; the root tier selects the
topology: ``controller`` (the driver folds partials in its own
process), ``worker`` (the top aggregator is itself a runtime
aggregator — a parked worker process under shmproc), or ``node`` (the
root lives on the busiest worker node and the other nodes ship their
sealed partials daemon→daemon, so only the final folded Σc·u returns
to the controller).
"""
from __future__ import annotations

import json
from bisect import bisect_left, insort
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple


@dataclass
class NodeState:
    node: str
    max_capacity: float          # MC_i (updates aggregated concurrently)
    arrival_rate: float = 0.0    # k_{i,t}
    exec_time_s: float = 1.0     # E_{i,t}
    assigned: float = 0.0        # updates placed this round
    # EWMA of the node's measured daemon→daemon ship cost per sealed
    # partial (PartialShipped.wire_s, src side) — 0 until telemetry
    # feeds it, so single-node behavior is untouched
    wire_time_s: float = 0.0

    @property
    def queue_estimate(self) -> float:
        """Q_{i,t} = k_{i,t} · E_{i,t} (§5.1)."""
        return self.arrival_rate * self.exec_time_s

    @property
    def residual_capacity(self) -> float:
        """RC_{i,t} = MC_i − k·E − already-assigned − ship load.

        Shipping a sealed partial occupies the node for ``wire_time_s``;
        priced in exec-time units (wire/E ≈ how many updates the node
        could have folded in that window) so a node with an expensive
        uplink looks correspondingly less spare to the packer and the
        root choice."""
        return self.residual_for(1.0)

    def residual_for(self, share: float = 1.0) -> float:
        """Residual capacity as seen by a job holding ``share`` of this
        node under weighted fair-share: the MC term scales with the
        job's share while the load terms (queue, assigned, ship —
        whoever caused them) charge in full.  Under contention every
        job therefore sees the node fill at the same absolute rate but
        against its own scaled ceiling, which converges to a
        weight-proportional split of MC (serve/README.md has the
        math).  ``share=1.0`` is the single-job model, unchanged."""
        ship_load = (self.wire_time_s / self.exec_time_s
                     if self.exec_time_s > 0 else 0.0)
        return (share * self.max_capacity - self.queue_estimate
                - self.assigned - ship_load)


def measure_max_capacity(exec_times: Sequence[Tuple[float, float]],
                         inflection: float = 1.5) -> float:
    """Offline MC estimation (App-E): walk (arrival_rate, E) pairs in
    increasing rate order; when E jumps by ``inflection``× over the base,
    the node is saturating — MC = k'·E' at that point."""
    if not exec_times:
        return 0.0
    base = exec_times[0][1]
    for k, e in exec_times:
        if e > inflection * base:
            return k * e
    k, e = exec_times[-1]
    return k * e


@dataclass
class Placement:
    assignment: Dict[str, List[int]]  # node -> update indices
    nodes_used: List[str]
    overflow: List[int]               # updates no node could take

    @property
    def num_nodes_used(self) -> int:
        return len(self.nodes_used)


def _fit_nodes(nodes: List[NodeState], policy: str,
               used: Optional[set] = None,
               share: float = 1.0) -> List[NodeState]:
    if policy == "bestfit":
        # tightest feasible bin first -> fewest nodes, max shared memory
        return sorted(nodes, key=lambda n: n.residual_for(share))
    if policy == "worstfit":
        # most headroom first -> spreads load (Knative Least Connection)
        return sorted(nodes, key=lambda n: -n.residual_for(share))
    if policy == "firstfit":
        return nodes
    if policy == "locality":
        # multi-node mode: every *additional* node used costs one sealed
        # model-size partial on the wire per round, so a subtree sticks
        # to nodes already holding part of the round (tightest such bin
        # first) and opens a fresh node — largest residual capacity, so
        # the new subtree absorbs the most before the next spill — only
        # when the used set is saturated
        used = used or set()
        return sorted(nodes, key=lambda n: (
            n.node not in used,
            n.residual_for(share) if n.node in used
            else -n.residual_for(share),
        ))
    raise ValueError(f"unknown placement policy {policy!r}")


def _place_reference(num_updates: int, nodes: Dict[str, NodeState],
                     policy: str, weights: List[float],
                     share: float) -> Placement:
    """The original O(U·N log N) packing loop: a full fleet sort per
    update.  Kept verbatim as the behavioral reference — the indexed
    path below must match it bit for bit (test-enforced), tie-breaks
    included."""
    assignment: Dict[str, List[int]] = {}
    overflow: List[int] = []
    live = list(nodes.values())

    for idx in range(num_updates):
        w = weights[idx]
        placed = False
        for cand in _fit_nodes(live, policy, used=set(assignment),
                               share=share):
            if cand.residual_for(share) >= w:
                assignment.setdefault(cand.node, []).append(idx)
                cand.assigned += w
                placed = True
                break
        if not placed:
            overflow.append(idx)

    used = [n for n in assignment]
    return Placement(assignment=assignment, nodes_used=used, overflow=overflow)


def _place_firstfit(num_updates: int, nodes: Dict[str, NodeState],
                    weights: List[float], share: float) -> Placement:
    """FirstFit with the invariant work hoisted: the candidate order
    never changes (fleet insertion order), so the reference loop's
    per-update ``set(assignment)`` rebuild and identity "sort" are
    lifted out of the loop entirely."""
    assignment: Dict[str, List[int]] = {}
    overflow: List[int] = []
    live = list(nodes.values())
    for idx in range(num_updates):
        w = weights[idx]
        for cand in live:
            if cand.residual_for(share) >= w:
                assignment.setdefault(cand.node, []).append(idx)
                cand.assigned += w
                break
        else:
            overflow.append(idx)
    used = [n for n in assignment]
    return Placement(assignment=assignment, nodes_used=used, overflow=overflow)


class PlacementState:
    """Persistent residual-capacity index over a node fleet.

    The packer needs candidates ordered by residual capacity; sorting
    the fleet once per update made a 10k-client round O(U·N log N)
    (~2.6 s at 500 nodes).  This index keeps the fleet sorted by
    ``(residual_for(share), rank)`` — ``rank`` is fleet-insertion
    order, which replicates the reference loop's stable-sort tie-break
    bit for bit — so one round packs in O(U log N), and the structure
    is repaired by *deltas* instead of rebuilt per round:

      * node join/leave/rejoin: :meth:`add` / :meth:`remove` (wired to
        the coordinator's ``NodeJoined``/``NodeLost``/``NodeRejoined``
        handlers);
      * EWMA-capacity drift and charge lift/apply: :meth:`sync`
        compares each cached residual against the live ``NodeState``
        (one float compare per node — the consistency backstop for
        mutations that bypass the handlers) and re-inserts only the
        entries that moved.

    Residuals are always read back through ``NodeState.residual_for``
    — never carried incrementally — so every comparison the packer
    makes uses the exact float the reference loop would compute.

    One index serves one ``share`` at a time; a share change (jobs
    joining/leaving a shared coordinator) rebuilds it in O(N log N),
    still free next to the packing loop it feeds.
    """

    def __init__(self, nodes: Dict[str, NodeState]):
        self.nodes = nodes
        self._rank: Dict[str, int] = {}
        self._next_rank = 0
        self._share: Optional[float] = None
        self._res: Dict[str, float] = {}      # node → cached residual
        self._entries: List[Tuple[float, int, str]] = []  # sorted

    # -- delta mutations ------------------------------------------------
    def add(self, ns: NodeState) -> None:
        """A node joined (or rejoined under a fresh NodeState)."""
        if ns.node in self._res:
            self.remove(ns.node)
        if self._share is None:
            return                       # never placed yet: lazy build
        self._rank[ns.node] = self._next_rank
        self._next_rank += 1
        r = ns.residual_for(self._share)
        self._res[ns.node] = r
        insort(self._entries, (r, self._rank[ns.node], ns.node))

    def remove(self, node: str) -> None:
        """A node left: drop its entry (a later rejoin re-ranks it at
        the end, matching the dict-insertion order the reference loop
        iterates in)."""
        r = self._res.pop(node, None)
        rank = self._rank.pop(node, None)
        if r is None or rank is None:
            return
        i = bisect_left(self._entries, (r, rank, ""))
        if i < len(self._entries) and self._entries[i][1] == rank:
            self._entries.pop(i)

    def sync(self, share: float) -> None:
        """Reconcile the index with the live fleet.  Same share: one
        float compare per node, O(changed) list repairs.  New share:
        full rebuild (the ordering key changed for every node)."""
        if share != self._share:
            self._share = share
            self._res = {}
            for node in self.nodes:
                if node not in self._rank:
                    self._rank[node] = self._next_rank
                    self._next_rank += 1
            self._rank = {n: k for n, k in self._rank.items()
                          if n in self.nodes}
            self._entries = []
            for node, ns in self.nodes.items():
                r = ns.residual_for(share)
                self._res[node] = r
                self._entries.append((r, self._rank[node], node))
            self._entries.sort()
            return
        for node in [n for n in self._res if n not in self.nodes]:
            self.remove(node)
        for node, ns in self.nodes.items():
            r = ns.residual_for(share)
            old = self._res.get(node)
            if old is None:
                self._rank.setdefault(node, self._next_rank)
                self._next_rank = max(self._next_rank,
                                      self._rank[node] + 1)
                self._res[node] = r
                insort(self._entries, (r, self._rank[node], node))
            elif old != r:
                self._requote(node, r)

    def _requote(self, node: str, r: float) -> None:
        old, rank = self._res[node], self._rank[node]
        i = bisect_left(self._entries, (old, rank, ""))
        if i < len(self._entries) and self._entries[i][1] == rank:
            self._entries.pop(i)
        self._res[node] = r
        insort(self._entries, (r, rank, node))

    # -- packing --------------------------------------------------------
    def place(self, num_updates: int, weights: List[float], policy: str,
              share: float) -> Placement:
        self.sync(share)
        if policy in ("bestfit", "worstfit"):
            return self._place_sorted(num_updates, weights, share,
                                      worst=(policy == "worstfit"))
        if policy == "locality":
            return self._place_locality(num_updates, weights, share)
        raise ValueError(f"unknown placement policy {policy!r}")

    def _take(self, i: int, idx: int, w: float, share: float,
              assignment: Dict[str, List[int]]) -> None:
        """Assign update ``idx`` to the node at entry ``i`` and re-key
        its entry from the post-placement residual."""
        r, rank, node = self._entries.pop(i)
        ns = self.nodes[node]
        assignment.setdefault(node, []).append(idx)
        ns.assigned += w
        r2 = ns.residual_for(share)
        self._res[node] = r2
        insort(self._entries, (r2, rank, node))

    def _place_sorted(self, num_updates: int, weights: List[float],
                      share: float, *, worst: bool) -> Placement:
        assignment: Dict[str, List[int]] = {}
        overflow: List[int] = []
        e = self._entries
        for idx in range(num_updates):
            w = weights[idx]
            if worst:
                # WorstFit = the max-residual node; among ties the
                # reference's stable sort keeps the lowest rank, which
                # is the leftmost entry of the max residual here
                if not e or e[-1][0] < w:
                    overflow.append(idx)
                    continue
                i = bisect_left(e, (e[-1][0], -1, ""))
            else:
                # BestFit = successor query: tightest residual ≥ w
                i = bisect_left(e, (w, -1, ""))
                if i >= len(e):
                    overflow.append(idx)
                    continue
            self._take(i, idx, w, share, assignment)
        used = [n for n in assignment]
        return Placement(assignment=assignment, nodes_used=used,
                         overflow=overflow)

    def _place_locality(self, num_updates: int, weights: List[float],
                        share: float) -> Placement:
        """Locality = BestFit over the nodes already holding part of
        the round, spilling to the *largest*-residual unused node only
        when the used set saturates (every extra node costs one sealed
        model-size partial on the wire)."""
        assignment: Dict[str, List[int]] = {}
        overflow: List[int] = []
        # call-scoped views (the used set resets every round); the
        # persistent index stays authoritative via _requote
        used_list: List[Tuple[float, int, str]] = []
        unused = sorted((-r, rank, node)
                        for (r, rank, node) in self._entries)
        for idx in range(num_updates):
            w = weights[idx]
            i = bisect_left(used_list, (w, -1, ""))
            if i < len(used_list):
                r, rank, node = used_list.pop(i)
            elif unused and -unused[0][0] >= w:
                nr, rank, node = unused.pop(0)
                r = -nr
            else:
                overflow.append(idx)
                continue
            ns = self.nodes[node]
            assignment.setdefault(node, []).append(idx)
            ns.assigned += w
            r2 = ns.residual_for(share)
            self._requote(node, r2)
            insort(used_list, (r2, rank, node))
        used = [n for n in assignment]
        return Placement(assignment=assignment, nodes_used=used,
                         overflow=overflow)


def place_updates(
    num_updates: int,
    nodes: Dict[str, NodeState],
    policy: str = "bestfit",
    weights: Optional[Sequence[float]] = None,
    *,
    share: float = 1.0,
    state: Optional[PlacementState] = None,
    method: str = "auto",
) -> Placement:
    """Bin-pack ``num_updates`` model updates onto worker nodes.

    Each update consumes 1 unit (or ``weights[i]``) of residual
    capacity.  Returns node -> update-index lists; inter-node traffic is
    minimized because any (src,dst) node pair exchanges at most one
    intermediate update per round (§5.1).

    ``share`` caps the placement at a weighted fair-share fraction of
    every node (multi-job serve mode): each update must fit within
    ``share × MC`` minus the node's current load, so concurrent jobs
    split the fleet in proportion to their weights instead of the
    first planner draining it.

    ``method="auto"`` packs through a sorted residual index
    (:class:`PlacementState`) in O(U log N) — bit-identical to the
    original per-update-sort loop, which ``method="reference"`` still
    runs (the regression oracle).  Pass ``state`` to reuse a
    persistent index across rounds (the coordinator does): the index
    is then repaired by deltas instead of rebuilt.
    """
    weights = list(weights) if weights is not None else [1.0] * num_updates
    if method == "reference":
        return _place_reference(num_updates, nodes, policy, weights, share)
    if policy == "firstfit":
        return _place_firstfit(num_updates, nodes, weights, share)
    if policy not in ("bestfit", "worstfit", "locality"):
        raise ValueError(f"unknown placement policy {policy!r}")
    if state is None or state.nodes is not nodes:
        state = PlacementState(nodes)
    return state.place(num_updates, weights, policy, share)


def choose_top_node(nodes: Dict[str, NodeState],
                    assignment: Dict[str, List[int]]) -> Optional[str]:
    """Top aggregator goes to the busiest used node: the largest share of
    intermediate updates is then already local to it (§5.2).  Ties are
    broken by the RC capacity model — the node with the most residual
    capacity absorbs the extra top fold best — then by name, so the
    root choice is deterministic across processes."""
    if not assignment:
        return None

    def rank(n: str):
        ns = nodes.get(n)
        rc = ns.residual_capacity if ns is not None else 0.0
        return (len(assignment[n]), rc, n)

    return max(assignment, key=rank)


# ---------------------------------------------------------------------------
# FoldPlan — the aggregation topology as an explicit, serializable tree
# ---------------------------------------------------------------------------

#: root tiers a plan may ask for (where the final fold executes)
FOLD_TIERS = ("controller", "worker", "node")


# Aggregator-id grammar: ``kind[:job][#round]@node``.  The bare form
# (``mid@node0``, ``top@node1``) is the single-job library path and
# stays byte-identical; the serve layer tags ids with the owning job
# and the driver round so (a) two in-flight rolling rounds never
# collide on a runtime task id and (b) warm-engine pools key by
# (job, tree-position) — the round tag is *stripped* for engine
# lookup so warmth carries across rounds but never across jobs.
# Everything downstream that wants the node keeps using
# ``agg_id.split("@", 1)[-1]``, which the grammar preserves.

def split_agg_id(agg_id: str) -> Tuple[str, str, Optional[int], str]:
    """``kind[:job][#round]@node`` → ``(kind, job, round, node)``
    (``job=''``/``round=None`` when untagged)."""
    pos, _, node = agg_id.partition("@")
    rid: Optional[int] = None
    if "#" in pos:
        pos, _, r = pos.partition("#")
        try:
            rid = int(r)
        except ValueError:
            rid = None
    kind, _, job = pos.partition(":")
    return kind, job, rid, node


def join_agg_id(kind: str, job: str = "", round_id: Optional[int] = None,
                node: str = "") -> str:
    """Inverse of :func:`split_agg_id`."""
    pos = kind
    if job:
        pos += f":{job}"
    if round_id is not None:
        pos += f"#{round_id}"
    return f"{pos}@{node}"


def agg_job(agg_id: str) -> str:
    """The job an aggregator id is tagged with ('' = single-job)."""
    return split_agg_id(agg_id)[1]


def engine_key(agg_id: str) -> str:
    """Warm-engine pool key: the (job, tree-position) identity — the
    per-round tag is dropped so ``mid:a#4@n0`` and ``mid:a#5@n0``
    share a resident accumulator, while job ``b`` at the same
    position never does."""
    kind, job, _rid, node = split_agg_id(agg_id)
    return join_agg_id(kind, job, None, node)


@dataclass(frozen=True)
class FoldSite:
    """One fold in the tree: an aggregator id bound to a node + tier.

    ``tier`` is where the fold executes: ``worker`` for mids (a runtime
    aggregator — an Aggregator object in-proc, a forked worker process
    under shmproc, a daemon-side aggregator under netrt); for the root
    it selects the round topology (see :class:`FoldPlan`)."""

    agg_id: str
    node: str
    tier: str                      # "controller" | "worker" | "node"
    goal: int                      # inputs this site folds
    children: Tuple[str, ...] = ()  # child site agg_ids (root only)


@dataclass(frozen=True)
class FoldPlan:
    """The round's aggregation topology: a tree of fold sites.

    Produced by :func:`build_fold_plan` (via ``Coordinator.plan_round``)
    and *executed* by ``RoundDriver`` — the driver interprets the plan
    instead of hard-coding a controller-side top fold.  The fold order
    is fixed by the plan (children sorted by agg_id), which is what
    keeps all three topologies bit-identical."""

    root: str = ""                 # root site agg_id ("" = empty round)
    sites: Tuple[FoldSite, ...] = ()

    def site(self, agg_id: str) -> FoldSite:
        for s in self.sites:
            if s.agg_id == agg_id:
                return s
        raise KeyError(f"no fold site {agg_id!r} in plan")

    @property
    def mids(self) -> Tuple[FoldSite, ...]:
        """The client-fed leaf sites, in plan order (sorted by node).
        Two-level plans have no inner sites, so this is every non-root
        site — the historical meaning, unchanged."""
        return tuple(s for s in self.sites
                     if s.agg_id != self.root and not s.children)

    @property
    def inners(self) -> Tuple[FoldSite, ...]:
        """Intermediate fold stages of a deep (fanout-capped) tree:
        non-root sites whose inputs are other sites' partials, not
        client updates.  Empty for two-level plans."""
        return tuple(s for s in self.sites
                     if s.agg_id != self.root and s.children)

    @property
    def depth(self) -> int:
        """Fold levels above the mids (1 = two-level: just the root)."""
        if not self.root:
            return 0
        sites = {s.agg_id: s for s in self.sites}

        def d(agg_id: str) -> int:
            s = sites[agg_id]
            if not s.children:
                return 0
            return 1 + max(d(c) for c in s.children)

        return d(self.root)

    @property
    def topology(self) -> str:
        return self.site(self.root).tier if self.root else "controller"

    def restamp(self, round_tag: Optional[int]) -> "FoldPlan":
        """Re-tag every site's agg_id with ``round_tag``, preserving
        the tree shape — the plan-cache seam: an unchanged cohort shape
        reuses the previous round's plan with only the round tag moved
        (returns ``self`` when no tag changes, so the untagged
        single-job path reuses the identical object)."""
        if not self.root:
            return self
        ids: Dict[str, str] = {}
        for s in self.sites:
            kind, job, _rid, node = split_agg_id(s.agg_id)
            ids[s.agg_id] = join_agg_id(kind, job, round_tag, node)
        if all(new == old for old, new in ids.items()):
            return self
        return FoldPlan(
            root=ids[self.root],
            sites=tuple(FoldSite(
                agg_id=ids[s.agg_id], node=s.node, tier=s.tier,
                goal=s.goal, children=tuple(ids[c] for c in s.children),
            ) for s in self.sites))

    # -- wire (same seam as events.to_wire: JSON bytes) -----------------
    def to_wire(self) -> bytes:
        return json.dumps({
            "plan": "FoldPlan",
            "root": self.root,
            "sites": [{"agg_id": s.agg_id, "node": s.node, "tier": s.tier,
                       "goal": s.goal, "children": list(s.children)}
                      for s in self.sites],
        }, separators=(",", ":")).encode("utf-8")

    @classmethod
    def from_wire(cls, raw) -> "FoldPlan":
        if isinstance(raw, (bytes, bytearray)):
            raw = raw.decode("utf-8")
        d = json.loads(raw)
        if d.get("plan") != "FoldPlan":
            raise ValueError(f"not a FoldPlan on the wire: {d.get('plan')!r}")
        return cls(
            root=d["root"],
            sites=tuple(FoldSite(
                agg_id=s["agg_id"], node=s["node"], tier=s["tier"],
                goal=int(s["goal"]), children=tuple(s["children"]),
            ) for s in d["sites"]),
        )


def choose_fanout(n_sites: int, nodes: Optional[Dict[str, NodeState]] = None,
                  cap: int = 16) -> Optional[int]:
    """Pick a fold-tree fanout from the fleet's measured cost EWMAs.

    The per-stage critical path is roughly ``K·E + W`` (K sequential
    ``add_partial`` folds of exec cost E, plus one partial ship of
    wire cost W to reach the stage's node) and the tree has
    ``ceil(log_K M)`` stages, so expensive shipping favors a *wider*
    tree (fewer hops) while expensive folding favors a narrower one.
    E/W come from the same ``NodeState`` EWMAs the capacity model
    runs on — ``exec_time_s`` is fed by ``PartialReady``/``TopFolded``
    exec stamps, ``wire_time_s`` by ``PartialShipped``.

    Baseline is ``K ≈ √M`` (two stages), widened by the measured
    wire/exec ratio and clamped to ``[2, cap]``.  Returns ``None`` —
    keep the two-level plan — when the site count is already a
    reasonable root fan-in."""
    if n_sites <= 4:
        return None
    exec_s = wire_s = 0.0
    if nodes:
        vals = list(nodes.values())
        exec_s = sum(ns.exec_time_s for ns in vals) / len(vals)
        wire_s = sum(ns.wire_time_s for ns in vals) / len(vals)
    ratio = (wire_s / exec_s) if exec_s > 0 else 0.0
    k = int(round(n_sites ** 0.5 * (1.0 + min(ratio, 3.0))))
    return max(2, min(k, cap, n_sites))


def build_fold_plan(
    assignment: Dict[str, List[int]],
    *,
    top_node: Optional[str] = None,
    topology: str = "controller",
    nodes: Optional[Dict[str, NodeState]] = None,
    job: str = "",
    round_tag: Optional[int] = None,
    fanout: Optional[int] = None,
) -> FoldPlan:
    """Reify a placement into the fold tree the driver executes.

    One mid per node with assigned updates (goal = its update count),
    plus a root folding the mids' partials.  ``topology`` picks the
    root tier; the root node defaults to :func:`choose_top_node` (the
    busiest node, RC tie-break) so under ``node`` topology the largest
    share of partials is already local to the root.

    ``fanout=K`` caps every fold's fan-in at K: more than K mids fold
    through intermediate ``fold<level>.<i>`` sites — log-depth stages
    of runtime aggregators — instead of one wide root fold.  Each
    inner site lands on its heaviest child's node (largest subtree
    update count, name tie-break), so the biggest input partial is
    already local and every inner stage ships at most ``K−1``
    partials; a trailing singleton group is hoisted to the next level
    instead of wrapped in a one-input fold, and an unpinned root
    co-locates with the heaviest final-level subtree — so plan-wide,
    cross-node partial traffic stays within the ``≤ leaves − 1`` a
    two-level plan ships (and under ``partial_traffic_bound``).
    ``None`` keeps the historical two-level tree bit for bit.

    ``job``/``round_tag`` stamp every site's agg_id with the serve
    layer's tags (see the agg-id grammar above); untagged plans keep
    the legacy ``mid@node`` / ``top@node`` ids bit for bit."""
    if topology not in FOLD_TIERS:
        raise ValueError(f"unknown fold topology {topology!r} "
                         f"(expected one of {FOLD_TIERS})")
    if fanout is not None and int(fanout) < 2:
        raise ValueError(f"fold fanout must be ≥ 2, got {fanout!r}")
    planned = {node: len(idxs) for node, idxs in assignment.items() if idxs}
    if not planned:
        return FoldPlan()
    mids = tuple(FoldSite(agg_id=join_agg_id("mid", job, round_tag, node),
                          node=node, tier="worker", goal=planned[node])
                 for node in sorted(planned))
    root_node = top_node or choose_top_node(nodes or {}, assignment)
    if root_node not in planned:
        root_node = max(planned, key=lambda n: (planned[n], n))
    sites: List[FoldSite] = list(mids)
    level: List[FoldSite] = list(mids)
    if fanout is not None and len(mids) > fanout:
        fanout = int(fanout)
        # subtree update counts drive inner-site placement (heaviest
        # child's node) the same way choose_top_node drives the root's
        counts = {s.agg_id: s.goal for s in mids}
        lvl = 0
        while len(level) > fanout:
            lvl += 1
            nxt: List[FoldSite] = []
            for gi in range(0, len(level), fanout):
                grp = level[gi:gi + fanout]
                if len(grp) == 1:
                    # a trailing singleton folds nothing: hoist it to
                    # the next level instead of paying a one-input
                    # fold stage for a pass-through
                    nxt.append(grp[0])
                    continue
                heavy = max(grp, key=lambda s: (counts[s.agg_id], s.node))
                site = FoldSite(
                    agg_id=join_agg_id(f"fold{lvl}.{gi // fanout}", job,
                                       round_tag, heavy.node),
                    node=heavy.node, tier="worker", goal=len(grp),
                    children=tuple(s.agg_id for s in grp))
                counts[site.agg_id] = sum(counts[s.agg_id] for s in grp)
                sites.append(site)
                nxt.append(site)
            level = nxt
        if top_node is None and level is not mids:
            # no pinned root: co-locate it with the heaviest final-
            # level subtree (the rule every inner stage follows), so
            # the deep tree's total cross-node partial traffic stays
            # at most a two-level plan's (≤ leaves − 1 ships)
            root_node = max(level,
                            key=lambda s: (counts[s.agg_id], s.node)).node
    root = FoldSite(
        agg_id=join_agg_id("top", job, round_tag, root_node),
        node=root_node, tier=topology,
        goal=len(level), children=tuple(s.agg_id for s in level),
    )
    return FoldPlan(root=root.agg_id, sites=tuple(sites) + (root,))


def plan_cross_node_transfers(plan: FoldPlan) -> int:
    """Parent↔child fold edges that cross nodes — each one ships one
    sealed model-size partial per round.  The deep-tree analogue of
    :func:`inter_node_transfers`; for a two-level plan the two agree
    exactly (every mid not on the root's node crosses once)."""
    if not plan.root:
        return 0
    sites = {s.agg_id: s for s in plan.sites}
    return sum(1 for s in plan.sites for c in s.children
               if sites[c].node != s.node)


def inter_node_transfers(assignment: Dict[str, List[int]], top_node: str) -> int:
    """One intermediate update crosses the network per non-top node used."""
    return sum(1 for n in assignment if n != top_node and assignment[n])


def cross_node_bytes(assignment: Dict[str, List[int]], top_node: str,
                     model_bytes: int) -> int:
    """Partials-only cross-node traffic per round under the paper's
    topology: one sealed Σc·u payload per non-top node used.  The
    locality policy exists to minimize this; ``bench_net`` gates the
    measured wire bytes against the controller-topology analogue
    (every node ships its partial to the driver-side top fold)."""
    return inter_node_transfers(assignment, top_node) * int(model_bytes)


def partial_traffic_bound(n_nodes: int, model_bytes: int,
                          slack: float = 1.1) -> int:
    """The acceptance bound for a round's cross-node aggregation
    traffic: partials only — nodes × model_size × slack.  Anything
    above it means per-client updates are fanning in to the top."""
    return int(n_nodes * model_bytes * slack)
