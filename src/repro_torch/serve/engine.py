"""Streaming-PCA fleet engine (counterpart of
``repro.serve.engine.StreamingPCAEngine``).

Each slot holds one live sensor network.  Every engine step stages each
active slot's next K rounds in ONE upload, folds them through
:func:`repro_torch.streaming.driver.fleet_chunk_step` — one fused-kernel
launch for the whole fleet on the fused stage path; on the split path
(``fused=False``, or quantized scores) one band-fold launch plus one
launch of each stage kernel (supervised compression, or projection and
reconstruction around the quantizer; monitoring); one band-fold launch
when no stage is configured — and retires exhausted streams with their
final basis and Table-1 bill.  Admission runs through the priority queue
(:mod:`repro_torch.serve.queue`), health through a per-slot
:class:`HealthMonitor` on a logical clock (one tick per step), and the
fleet mesh is re-planned by :func:`plan_mesh` when the live count
changes — all as in the reference.

Staging is double-buffered in both modes, as in the reference: two
engine-owned host buffers of each kind (the batch, the liveness masks and
the round validity), filled alternately and uploaded as owned device
copies.  On the card the buffers are pinned, the uploads run on an
engine-owned copy stream, and the compute stream (torch's current stream,
where every kernel launches) waits on the upload's event before the fold
reads it; a buffer is refilled only once its previous upload's event has
completed (the transfer fence — a wait on the copy-out, never on the
fold).  With ``pipeline=True`` chunk t+1 is filled and uploaded right
after chunk t's step is dispatched; a prestaged chunk is used only if the
slot plan did not move under it.  Overlap reorders host work only, so
the pipelined engine gives the synchronous engine's bits.

The fleet state stays on the device and is updated in place every step
(each state tensor keeps its memory, the counterpart of the reference's
donated buffers; contract ``engine.step``); the books
accumulate on the device, and every device-to-host copy goes through
:meth:`StreamingPCAEngine._pull` under a ledger key: the retirement
summaries (``"retire"``) and the fleet merge (``"merge"``); ``"hot"``
stays 0.  With ``precision="bf16"`` the fused path launches kernel 1 in
its bf16 tile mode; the chunks are uploaded in fp32 all the same, since
the statistics and the books read fp32 readings.
:meth:`StreamingPCAEngine.fleet_summary` merges the retired regions'
bases into the two-level fleet basis
(:func:`repro_torch.streaming.hierarchy.merge_fleet`).  The LM ``Engine``
of the reference module has no counterpart here.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.core import costs
from repro_torch.core.faults import expected_transmissions
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.runtime.elastic import RescalePlan, plan_mesh
from repro_torch.runtime.health import HealthMonitor, StragglerPolicy
from repro_torch.serve.queue import AdmissionQueue, QueuePolicy
from repro_torch.serve.telemetry import StepRecord, TelemetryRecorder
from repro_torch.streaming.detector import detection_packet_split
from repro_torch.streaming.driver import (StreamConfig, StreamState,
                                          fleet_chunk_step, random_bases,
                                          stream_init, tree_map)
from repro_torch.streaming.hierarchy import (fleet_basis_dense,
                                             merge_fleet, region_energies)
from repro_torch.streaming.online_cov import (online_estimate,
                                              online_total_variance)
from repro_torch.streaming.scheduler import retained_fraction

__all__ = ["StreamRequest", "StreamResult", "FleetSummary",
           "StreamingPCAEngine"]

# the step and the callees that touch the device (repolint's host-pull
# rule; the retirement's host side runs on what _pull copied)
HOT_PATHS = ("StreamingPCAEngine.step", "StreamingPCAEngine._commit",
             "StreamingPCAEngine._admit",
             "StreamingPCAEngine._stage", "StreamingPCAEngine._upload",
             "StreamingPCAEngine._accumulate_books",
             "StreamingPCAEngine._result_slices",
             "StreamingPCAEngine._pull")


@dataclasses.dataclass(eq=False)   # identity equality: requests hold arrays
class StreamRequest:
    """One live sensor network: a finite stream of measurement rounds
    (fields as in the reference)."""

    rounds: np.ndarray               # (R, n, p) float32 measurement rounds
    liveness: np.ndarray | None = None   # (R, p) per-round sensor liveness
    region: int = 0                  # region id in the two-level fleet
    priority: int = 0                # admission priority (higher first)
    tenant: str | None = None        # quota bucket (None: unmetered)
    result: "StreamResult | None" = None
    done: bool = False
    retirements: list = dataclasses.field(default_factory=list)
    resume_at: int = 0


@dataclasses.dataclass(frozen=True)
class StreamResult:
    """Final per-network summary returned when a stream retires."""

    components: np.ndarray           # (p, q) final basis
    retained: float                  # rho of the final basis on the live cov
    refreshes: int                   # scheduled basis recomputations
    comm_packets: float              # Table-1 communication bill (packets)
    rounds: int                      # rounds streamed
    reason: str = "completed"        # "completed" | "dead"
    energies: np.ndarray | None = None    # (q,) subspace energies
    total_variance: float | None = None   # trace(C) partial
    compression_max_err: float | None = None
    compression_extra_packets: float | None = None
    compression_bits_on_air: float | None = None
    detection_events: float | None = None
    detection_alarm_packets: float | None = None
    detection_t2_threshold: float | None = None
    detection_spe_threshold: float | None = None


@dataclasses.dataclass(frozen=True)
class FleetSummary:
    """The two-level fleet basis merged from retired region results (fields
    as in the reference): the dense block-embedded basis, the compact
    (region, column) selection with its energies, the fleet retained
    fraction and the Table-1 bill of the merge epoch."""

    basis: np.ndarray                # (p_fleet, q_fleet)
    region: np.ndarray               # (q_fleet,) owning region per component
    col: np.ndarray                  # (q_fleet,) column within that region
    lam: np.ndarray                  # (q_fleet,) energies, descending
    rho: float                       # fleet retained fraction
    regions: tuple                   # region ids merged, ascending
    merge_packets: float             # region-head bill of this merge epoch


@dataclasses.dataclass
class _StagedChunk:
    """One staged upload and the host plan it was built from; ``signature``
    pins the slot plan (request identity and cursor per slot), and
    ``ready`` is the upload's event on the copy stream (None off the
    card)."""

    batch: torch.Tensor              # (slots, K, n, p) owned device copy
    masks: torch.Tensor | None       # (slots, K, p) or None (no schedules)
    rv: torch.Tensor                 # (slots, K) round validity
    start: np.ndarray                # cursor snapshot at staging time
    consumed: np.ndarray             # rounds each slot will fold
    signature: tuple                 # plan token (see _plan_signature)
    ready: torch.cuda.Event | None


@dataclasses.dataclass
class _StagingBuffers:
    """One parity's staging buffers: the (batch, masks, rv) sources —
    pinned tensors on the card, numpy arrays elsewhere — their numpy views,
    and the last upload's event (card only)."""

    sources: tuple
    batch: np.ndarray                # (slots, K, n, p)
    masks: np.ndarray                # (slots, K, p)
    rv: np.ndarray                   # (slots, K)
    upload: torch.cuda.Event | None = None

    def views(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        return self.batch, self.masks, self.rv


class StreamingPCAEngine:
    """Continuous batching over sensor-network streams, fault-aware.

    Parameters as in the reference (``pipeline``: stage chunk t+1 while
    chunk t folds), plus ``init_bases`` — the (slots, p, q) orthonormal
    bases every slot starts (and restarts) from, drawn from
    ``torch.Generator(seed)`` when None — and ``device`` (``cuda`` unless
    the caller asks for another; raises without a card).  On the card the
    staging buffers are pinned and uploaded on a side stream; a failed pin
    or stream raises.
    """

    def __init__(self, cfg: StreamConfig, slots: int = 8, seed: int = 0,
                 health_policy: StragglerPolicy | None = None,
                 min_alive_fraction: float = 0.25, chunk: int = 1,
                 pipeline: bool = False,
                 queue: QueuePolicy | AdmissionQueue | None = None,
                 telemetry: TelemetryRecorder | bool | None = None, *,
                 init_bases: torch.Tensor | None = None,
                 device: str | torch.device = "cuda"):
        if chunk < 1:
            raise ValueError(f"chunk must be >= 1, got {chunk}")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.slots = slots
        self.chunk = chunk
        self.pipeline = pipeline
        self.min_alive_fraction = min_alive_fraction
        self.health_policy = health_policy or StragglerPolicy(
            stall_timeout=2.5)          # logical steps, not seconds
        if init_bases is None:
            init_bases = random_bases(slots, cfg.p, cfg.q, seed,
                                      device=self.device)
        # every admission re-initializes its slot from this fresh fleet
        self._fresh_states: StreamState = stream_init(
            cfg, slots, init_bases=init_bases, device=self.device)
        self.states: StreamState = tree_map(torch.clone, self._fresh_states)
        self.active: list[StreamRequest | None] = [None] * slots
        self.cursor = np.zeros(slots, np.int64)
        self.queue: AdmissionQueue = (
            queue if isinstance(queue, AdmissionQueue)
            else AdmissionQueue(queue))
        self.telemetry: TelemetryRecorder | None = (
            TelemetryRecorder() if telemetry is True else telemetry or None)
        self.slot_region = np.full(slots, -1, np.int64)
        self.region_results: dict[int, StreamResult] = {}
        self._n: int | None = None
        # double-buffered staging, one record per parity
        self._staging: list[_StagingBuffers | None] = [None, None]
        self._parity = 0
        self._staged: _StagedChunk | None = None
        self._copy_stream = (torch.cuda.Stream(self.device)
                             if self.device.type == "cuda" else None)
        # every device-to-host copy goes through _pull under one of these
        # keys; "hot" stays 0
        self.pulls = {"hot": 0, "retire": 0, "merge": 0}
        self._transfer_fences = 0
        self._prestage_hits = 0
        self._prestage_misses = 0
        zeros = lambda: torch.zeros(slots, device=self.device)
        self._comp_max_err, self._comp_extras, self._comp_bits = (
            zeros(), zeros(), zeros())
        self.last_compression = None
        self._det_events, self._det_alarm_packets = zeros(), zeros()
        self.last_detection = None
        if cfg.detection is not None:
            _, per_alarm = detection_packet_split(cfg.q, cfg.c_max)
            self._det_alarm_price = per_alarm * expected_transmissions(
                cfg.link_loss, cfg.max_retries)
        self._clock = 0
        self.health: list[HealthMonitor | None] = [None] * slots
        self.retired_log: list[tuple[StreamRequest, str]] = []
        self._last_live = slots
        self.plan: RescalePlan = plan_mesh(max(1, slots), prefer_model=1,
                                           global_batch=max(1, slots))
        self.plan_history: list[RescalePlan] = [self.plan]

    # -- request lifecycle ----------------------------------------------------
    def submit(self, req: StreamRequest) -> bool:
        """Enqueue a stream; returns False when the bounded queue rejected
        it (backpressure — the caller owns the retry)."""
        r, n, p = req.rounds.shape
        if p != self.cfg.p:
            raise ValueError(f"stream p={p} != engine p={self.cfg.p}")
        if r == 0:
            raise ValueError("stream has no rounds")
        if req.liveness is not None and req.liveness.shape != (r, p):
            raise ValueError(
                f"liveness shape {req.liveness.shape} != {(r, p)}")
        if self._n is None:
            self._n = n
        elif n != self._n:
            raise ValueError(f"stream n={n} != engine n={self._n}")
        ok = self.queue.submit(req, priority=req.priority, tenant=req.tenant)
        if not ok and self.telemetry is not None:
            self.telemetry.record_event("rejected", step=self._clock,
                                        priority=req.priority,
                                        tenant=req.tenant,
                                        queue_depth=len(self.queue))
        return ok

    def _tenant_load(self) -> dict:
        load: dict = {}
        for req in self.active:
            if req is not None and req.tenant is not None:
                load[req.tenant] = load.get(req.tenant, 0) + 1
        return load

    def _admit(self) -> int:
        """Fill empty slots from the queue (priority order, tenant quotas),
        then reset every admitted slot's device state in one select per
        state leaf.  Returns the number admitted."""
        newly: list[int] = []
        load = self._tenant_load()
        for slot in range(self.slots):
            if self.active[slot] is not None:
                continue
            entry = self.queue.pop_admissible(load)
            if entry is None:
                break
            req = entry.req
            self.active[slot] = req
            self.cursor[slot] = req.resume_at
            self.slot_region[slot] = req.region
            if req.tenant is not None:
                load[req.tenant] = load.get(req.tenant, 0) + 1
            newly.append(slot)
            monitor = HealthMonitor(self.health_policy,
                                    clock=lambda: float(self._clock))
            monitor.heartbeat(step=self._clock, duration=1.0)
            self.health[slot] = monitor
            if self.telemetry is not None:
                self.telemetry.record_event(
                    "admitted", step=self._clock, slot=slot,
                    priority=entry.priority, tenant=entry.tenant,
                    resume_at=int(req.resume_at))
        if not newly:
            return 0
        # the (slots,) admission mask, filled run by run on the device:
        # no host copy, so no wait on the stream
        mj = torch.zeros(self.slots, dtype=torch.bool, device=self.device)
        first = prev = newly[0]
        for s in newly[1:] + [None]:
            if s != prev + 1:
                mj[first:prev + 1].fill_(True)
                first = s
            prev = s

        def splice(full, fresh):
            sel = mj.reshape((self.slots,) + (1,) * (fresh.dim() - 1))
            return full.copy_(torch.where(sel, fresh, full))

        tree_map(splice, self.states, self._fresh_states)
        zero = torch.zeros((), device=self.device)
        if self.cfg.compression is not None:
            self._comp_max_err = torch.where(mj, zero, self._comp_max_err)
            self._comp_extras = torch.where(mj, zero, self._comp_extras)
            self._comp_bits = torch.where(mj, zero, self._comp_bits)
        if self.cfg.detection is not None:
            self._det_events = torch.where(mj, zero, self._det_events)
            self._det_alarm_packets = torch.where(mj, zero,
                                                  self._det_alarm_packets)
        return len(newly)

    # -- retirement -----------------------------------------------------------
    def _pull(self, x: torch.Tensor, where: str) -> np.ndarray:
        """The engine's only device-to-host copy, counted under ``where``
        in ``pulls`` ("retire", "merge"; "hot" must stay 0)."""
        self.pulls[where] = self.pulls.get(where, 0) + 1
        # repolint: allow-host-pull the one counted device-to-host copy
        return x.cpu().numpy()

    def _result_slices(self, slot: int) -> tuple[dict, torch.Tensor]:
        """The retiring slot's summary, copied on the device into one flat
        fp32 tensor before any admission can overwrite the slot (the fleet
        state is updated in place): the fields' shapes and that tensor."""
        st = tree_map(lambda a: a[slot], self.states)
        # one C W serves both the retained fraction and the energies
        band_est = online_estimate(st.cov)
        cw = ops.banded_matmul(band_est, st.sched.W)
        out = dict(
            W=st.sched.W,
            rho=retained_fraction(band_est, st.sched.W,
                                  online_total_variance(st.cov), cw=cw),
            refreshes=st.sched.refreshes, comm_packets=st.sched.comm_packets,
            rounds=st.rounds)
        out["lam"], out["total"] = region_energies(st, cw=cw)
        if self.cfg.compression is not None:
            out.update(comp_max=self._comp_max_err[slot],
                       comp_extra=self._comp_extras[slot],
                       comp_bits=self._comp_bits[slot])
        if self.cfg.detection is not None:
            out.update(det_events=self._det_events[slot],
                       det_alarms=self._det_alarm_packets[slot],
                       det_t2=st.det.t2_threshold,
                       det_spe=st.det.spe_threshold)
        return ({k: tuple(v.shape) for k, v in out.items()},
                torch.cat([v.reshape(-1).to(torch.float32)
                           for v in out.values()]))

    def _finalize_result(self, slices: tuple[dict, torch.Tensor],
                         reason: str) -> StreamResult:
        """Copy a retiring slot's summary to the host in ONE transfer — the
        loop's only device-to-host copy — and build its StreamResult (the
        integer fields, round and refresh counts, are exact in fp32)."""
        shapes, snapshot = slices
        flat = self._pull(snapshot, "retire")
        out, at = {}, 0
        for k, shape in shapes.items():
            size = int(np.prod(shape, dtype=np.int64))
            out[k] = flat[at:at + size].reshape(shape)
            at += size
        extra: dict = {}
        if self.cfg.compression is not None:
            extra = dict(
                compression_max_err=float(out["comp_max"]),
                compression_extra_packets=float(out["comp_extra"]),
                compression_bits_on_air=float(out["comp_bits"]))
        if self.cfg.detection is not None:
            extra.update(
                detection_events=float(out["det_events"]),
                detection_alarm_packets=float(out["det_alarms"]),
                detection_t2_threshold=float(out["det_t2"]),
                detection_spe_threshold=float(out["det_spe"]))
        return StreamResult(
            components=out["W"], retained=float(out["rho"]),
            refreshes=int(out["refreshes"]),
            comm_packets=float(out["comm_packets"]),
            rounds=int(out["rounds"]), reason=reason,
            energies=out["lam"], total_variance=float(out["total"]),
            **extra)

    def _begin_retire(self, slot: int, reason: str) -> dict:
        """Snapshot the slot's summary, free the slot, and — for a dead
        retirement whose liveness schedule shows a revival — re-queue the
        continuation (exempt from the queue bound)."""
        req = self.active[slot]
        pending = dict(req=req, reason=reason, slot=slot,
                       region=int(self.slot_region[slot]),
                       slices=self._result_slices(slot), revive=None)
        self.active[slot] = None
        self.slot_region[slot] = -1
        self.health[slot] = None
        if reason == "dead" and req.liveness is not None:
            frac = req.liveness[int(self.cursor[slot]):].mean(axis=1)
            ahead = np.nonzero(frac >= self.min_alive_fraction)[0]
            if ahead.size:
                pending["revive"] = int(self.cursor[slot]) + int(ahead[0])
                req.resume_at = pending["revive"]
                self.queue.submit(req, priority=req.priority,
                                  tenant=req.tenant, internal=True)
        return pending

    def _finish_retire(self, pending: dict) -> None:
        req, reason = pending["req"], pending["reason"]
        result = self._finalize_result(pending["slices"], reason)
        self.retired_log.append((req, reason))
        if reason == "dead" and pending["revive"] is not None:
            req.retirements.append(result)
        else:
            req.result = result
            req.done = True
            self.region_results[pending["region"]] = result
        if self.telemetry is not None:
            self.telemetry.record_event(
                "retired", step=self._clock, slot=pending["slot"],
                reason=reason, tenant=req.tenant,
                rounds=result.rounds, comm_packets=result.comm_packets,
                refreshes=result.refreshes, revive=pending["revive"])

    def _replan(self, n_live: int) -> None:
        """Elastic fleet mesh: one virtual device per live network."""
        if n_live != self._last_live and n_live > 0:
            self.plan = plan_mesh(n_live, prefer_model=1,
                                  global_batch=n_live)
            self.plan_history.append(self.plan)
        self._last_live = n_live

    # -- staging (double-buffered) -------------------------------------------
    def _plan_signature(self) -> tuple:
        """The slot plan a staged chunk depends on: per-slot request
        identity and cursor.  Any admission, retirement or resumed
        continuation moves it, invalidating a prestaged chunk."""
        return tuple(
            (id(self.active[s]), int(self.cursor[s]))
            if self.active[s] is not None else None
            for s in range(self.slots))

    def _allocate_buffers(self) -> _StagingBuffers:
        """One parity's batch, mask and round-validity buffers: pinned
        tensors on the card (filled through their numpy views), numpy
        arrays elsewhere."""
        K, p = self.chunk, self.cfg.p
        shapes = ((self.slots, K, self._n, p), (self.slots, K, p),
                  (self.slots, K))
        if self._copy_stream is None:
            srcs = tuple(np.zeros(shape, np.float32) for shape in shapes)
            views = srcs
        else:
            srcs = tuple(torch.zeros(shape, dtype=torch.float32,
                                     pin_memory=True) for shape in shapes)
            if not all(t.is_pinned() for t in srcs):
                raise RuntimeError("staging buffers were not pinned")
            views = tuple(t.numpy() for t in srcs)
        return _StagingBuffers(srcs, *views)

    def _upload(self, src) -> torch.Tensor:
        """An owned device copy of a staging buffer ``src``.  On the card
        (``src`` pinned) the copy runs on the copy stream without blocking
        the host, and the result is marked as used by the compute stream,
        so the allocator keeps its memory until the fold has read it;
        elsewhere (``src`` a numpy array) a plain copy."""
        if self._copy_stream is None:
            return torch.from_numpy(src).to(self.device, copy=True)
        compute = torch.cuda.current_stream(self.device)
        with torch.cuda.stream(self._copy_stream):
            dst = src.to(self.device, non_blocking=True)
        dst.record_stream(compute)
        return dst

    def _stage(self) -> _StagedChunk:
        """Fill the next parity's host buffers with every active slot's
        next K rounds and upload them.  Idle slots carry a zero chunk with
        zero round validity; a slot whose stream ends mid-chunk stages
        only its real tail rounds; the mask batch is uploaded only when
        some active request carries a liveness schedule."""
        K = self.chunk
        i = self._parity
        self._parity ^= 1
        bufs = self._staging[i]
        if bufs is None:
            bufs = self._staging[i] = self._allocate_buffers()
        else:
            # transfer fence: this buffer's previous upload must have left
            # the host memory about to be overwritten (never a wait on the
            # fold)
            self._transfer_fences += 1
            if bufs.upload is not None:
                bufs.upload.synchronize()
        buf, mbuf, rv = bufs.views()
        rv[:] = 0.0
        consumed = np.zeros(self.slots, np.int64)
        start = self.cursor.copy()
        any_schedule = False
        for s in range(self.slots):
            req = self.active[s]
            if req is None:
                buf[s] = 0.0
                continue
            c = int(start[s])  # repolint: allow-host-pull numpy cursor
            take = min(K, req.rounds.shape[0] - c)
            buf[s, :take] = req.rounds[c:c + take]
            if take < K:
                buf[s, take:] = 0.0
            rv[s, :take] = 1.0
            consumed[s] = take
            any_schedule |= req.liveness is not None
        if any_schedule:
            for s in range(self.slots):
                req = self.active[s]
                if req is None or req.liveness is None:
                    mbuf[s] = 1.0
                    continue
                # repolint: allow-host-pull numpy cursors
                c, take = int(start[s]), int(consumed[s])
                mbuf[s, :take] = req.liveness[c:c + take]
                if take < K:
                    mbuf[s, take:] = 1.0
        b_src, m_src, rv_src = bufs.sources
        batch = self._upload(b_src)
        masks = self._upload(m_src) if any_schedule else None
        rv_dev = self._upload(rv_src)
        ready = None
        if self._copy_stream is not None:
            ready = torch.cuda.Event()
            ready.record(self._copy_stream)
        bufs.upload = ready
        return _StagedChunk(batch=batch, masks=masks, rv=rv_dev, start=start,
                            consumed=consumed,
                            signature=self._plan_signature(), ready=ready)

    def _accumulate_books(self, metrics, rv: torch.Tensor) -> None:
        """Fold the step's stage outputs into the per-slot device accounts;
        idle slots are selected out (where, not multiply).  A live slot
        stages at least one round, so the staged round validity ``rv``
        (slots, K) gives the live mask on the device."""
        lmj = rv[:, 0] > 0
        zero = torch.zeros((), device=self.device)
        if self.cfg.compression is not None:
            comp = metrics.compression
            self.last_compression = comp
            self._comp_max_err = torch.maximum(
                self._comp_max_err, torch.where(lmj, comp.max_err, zero))
            self._comp_extras = self._comp_extras + torch.where(
                lmj, comp.extra_packets, zero)
            self._comp_bits = self._comp_bits + torch.where(
                lmj, comp.bits_on_air, zero)
        if self.cfg.detection is not None:
            det = metrics.detection
            self.last_detection = det
            alarms = torch.where(lmj, det.alarms, zero)
            self._det_events = self._det_events + alarms
            self._det_alarm_packets = (self._det_alarm_packets
                                       + alarms * self._det_alarm_price)

    # -- main loop ------------------------------------------------------------
    def _commit(self, new_states: StreamState) -> None:
        """Write the step's states into the fleet state in place: every
        state tensor keeps its memory across steps (the counterpart of the
        reference's donated state; contract ``engine.step``)."""
        tree_map(lambda dst, src: dst.copy_(src), self.states, new_states)

    def step(self) -> int:
        """Fold the next K-round chunk for every active slot; returns the
        number of active slots.

        The chunk comes from the previous step's prestage when the slot
        plan has not moved (``pipeline=True``), else it is staged here.
        After the fold is dispatched and the host bookkeeping is done, the
        pipelined engine admits again and prestages chunk t+1; only then
        are the retirement results pulled — the loop's only device-to-host
        copies."""
        t0 = time.perf_counter()
        admitted = self._admit()
        self._clock += 1
        live = [s for s in range(self.slots) if self.active[s]]
        self._replan(len(live))
        if not live:
            self._staged = None
            if self.telemetry is not None:
                self.telemetry.record_step(StepRecord(
                    step=self._clock, wall_s=time.perf_counter() - t0,
                    stage_s=0.0, overlap_s=0.0, prestaged=False, live=0,
                    rounds=0, queue_depth=len(self.queue),
                    admitted=admitted, retired=0))
            return 0
        # -- chunk t: the prestaged upload, or staged here -----------------
        staged, self._staged = self._staged, None
        prestaged = (staged is not None
                     and staged.signature == self._plan_signature())
        stage_s = 0.0
        if prestaged:
            self._prestage_hits += 1
        else:
            self._prestage_misses += 1
            t_s = time.perf_counter()
            staged = self._stage()
            stage_s = time.perf_counter() - t_s
        # -- dispatch: the compute stream waits for the upload -------------
        if staged.ready is not None:
            torch.cuda.current_stream(self.device).wait_event(staged.ready)
        new_states, metrics = fleet_chunk_step(
            self.cfg, self.states, staged.batch, staged.masks, staged.rv)
        self._commit(new_states)
        self._accumulate_books(metrics, staged.rv)
        # -- host bookkeeping: heartbeats, cursors, retirement verdicts ----
        pendings: list[dict] = []
        for s in live:
            req = self.active[s]
            # repolint: allow-host-pull numpy: the staged plan and schedule
            c, take = int(staged.start[s]), int(staged.consumed[s])
            # repolint: allow-host-pull numpy: the request's schedule
            frac = 1.0 if req.liveness is None \
                else float(req.liveness[c:c + take].mean())
            if frac >= self.min_alive_fraction:
                self.health[s].heartbeat(step=self._clock, duration=1.0)
            self.cursor[s] += take
            if self.cursor[s] >= req.rounds.shape[0]:
                pendings.append(self._begin_retire(s, "completed"))
            elif self.health[s].stalled():
                pendings.append(self._begin_retire(s, "dead"))
        # -- pipelined prestage: chunk t+1 while chunk t folds -------------
        overlap_s = 0.0
        if self.pipeline:
            admitted += self._admit()
            if any(r is not None for r in self.active):
                t_s = time.perf_counter()
                self._staged = self._stage()
                overlap_s = time.perf_counter() - t_s
                stage_s += overlap_s
        # -- retirement results: the loop's only device-to-host pulls ------
        for pending in pendings:
            self._finish_retire(pending)
        if self.telemetry is not None:
            self.telemetry.record_step(StepRecord(
                step=self._clock, wall_s=time.perf_counter() - t0,
                stage_s=stage_s, overlap_s=overlap_s, prestaged=prestaged,
                # repolint: allow-host-pull numpy: the staged plan
                live=len(live), rounds=int(staged.consumed.sum()),
                queue_depth=len(self.queue), admitted=admitted,
                retired=len(pendings)))
        return len(live)

    def run_until_done(self, max_steps: int = 100_000) -> None:
        for _ in range(max_steps):
            if self.step() == 0 and not self.queue:
                return

    # -- two-level fleet merge -------------------------------------------------
    def fleet_summary(self, q_fleet: int | None = None,
                      c_regions: int | None = None) -> FleetSummary:
        """Merge the retired regions' bases into the fleet-level basis: one
        merge epoch over the latest final result per region id — global
        top-``q_fleet`` selection by subspace energy
        (:func:`~repro_torch.streaming.hierarchy.merge_fleet`), the dense
        block embedding, and the merge's Table-1 bill at region-tree
        fan-out ``c_regions`` (default ``cfg.c_max``), ARQ-scaled.  The
        merge runs on the engine's device; its result comes back in one
        pull (``pulls["merge"]``)."""
        if not self.region_results:
            raise ValueError("no retired region results to merge")
        regions = sorted(self.region_results)
        results = [self.region_results[r] for r in regions]
        lam_table = torch.from_numpy(
            np.stack([r.energies for r in results])).to(self.device)
        total = torch.tensor(sum(r.total_variance for r in results),
                             dtype=torch.float32, device=self.device)
        qf = self.cfg.q if q_fleet is None else q_fleet
        basis = merge_fleet(lam_table, total, qf)
        W_regions = torch.from_numpy(
            np.stack([r.components for r in results])).to(self.device)
        parts = (fleet_basis_dense(basis, W_regions), basis.region,
                 basis.col, basis.lam, basis.rho)
        flat = self._pull(torch.cat([t.reshape(-1).to(torch.float32)
                                     for t in parts]), "merge")
        out, at = [], 0
        for t in parts:
            out.append(flat[at:at + t.numel()].reshape(tuple(t.shape)))
            at += t.numel()
        cr = self.cfg.c_max if c_regions is None else c_regions
        bill = costs.lossy_merge_cost(self.cfg.q, cr, self.cfg.link_loss,
                                      self.cfg.max_retries).communication
        return FleetSummary(
            basis=out[0], region=out[1].astype(np.int32),
            col=out[2].astype(np.int32), lam=out[3], rho=float(out[4]),
            regions=tuple(regions), merge_packets=float(bill))


# ===========================================================================
# Program contracts (checked by ``python -m repro_torch.analysis.check``):
# an engine serving one request a slot for 3 steps — 2 slots of p = 8 on
# the CPU, 8 slots at the engine's widths on the card — with both stages
# (kernel 1) or band-only with one request under a liveness schedule
# (kernel 3).  On the card the host syncs are read by call site too.
# ===========================================================================
from repro_torch.analysis import contracts as _contracts  # noqa: E402
from repro_torch.analysis import op_lint as _ol  # noqa: E402
from repro_torch.streaming.compressor import CompressionConfig  # noqa: E402
from repro_torch.streaming.detector import DetectionConfig  # noqa: E402

_STEPS, _REFRESH_ITERS = 3, 8
_CHUNK_KERNELS = ("fused_stream", "fused_stream_bf16", "band_fold",
                  "band_fold_masked")


def _state_ptrs(states) -> tuple:
    ptrs = []
    tree_map(lambda t: ptrs.append(t.data_ptr()), states)
    return tuple(ptrs)


def _contract_engine(dev, pipeline: bool, stages: bool):
    """An engine with one request a slot, each ``_STEPS`` chunks long; in
    the band-only variant request 0 carries a liveness schedule."""
    slots, p, q, h, n, K = ((8, 1024, 32, 128, 32, 8) if dev.type == "cuda"
                            else (2, 8, 2, 1, 4, 2))
    cfg = StreamConfig(
        p=p, q=q, halfwidth=h, warmup_rounds=2, refresh_iters=_REFRESH_ITERS,
        compression=CompressionConfig(epsilon=0.5) if stages else None,
        detection=(DetectionConfig(alpha=1e-3, calib_rounds=2) if stages
                   else None))
    eng = StreamingPCAEngine(cfg, slots=slots, seed=0, chunk=K,
                             pipeline=pipeline, device=dev)
    rng = np.random.default_rng(0)
    for i in range(slots):
        live = None
        if not stages and i == 0:
            live = np.ones((_STEPS * K, p), np.float32)
            live[K:, : p // 4] = 0.0
        eng.submit(StreamRequest(
            rounds=rng.normal(size=(_STEPS * K, n, p)).astype(np.float32),
            liveness=live))

    def serve():
        ptrs = [_state_ptrs(eng.states)]
        while eng.step() or eng.queue:
            ptrs.append(_state_ptrs(eng.states))
        return dict(state_ptrs=ptrs, steps=eng._clock,
                    retired=len(eng.retired_log), pulls=dict(eng.pulls),
                    prestage_hits=eng._prestage_hits,
                    prestage_misses=eng._prestage_misses)
    return serve


def _engine_runs(dev, pipeline=False):
    return {f"{kind}": _contract_engine(dev, pipeline, kind == "stages")
            for kind in ("stages", "band-masked")}


_ENGINE_RULES = (
    # one chunk launch a step (the step after the last retirement has no
    # live slot and launches nothing)
    _ol.KernelBudget(_CHUNK_KERNELS, exact=_STEPS),
    # every decision's refresh products, plus one a retirement
    _ol.KernelBudget("banded_matmul", exact=lambda rec: _STEPS * (
        1 + _REFRESH_ITERS + 2) + rec.result["retired"]),
    _ol.OpBudget(_ol.EIGH_OP, exact=_STEPS),
    _ol.InPlaceState(),
    _ol.NoHostRead(allowed_sites=("_pull",)),
    _ol.NoF64())

_contracts.register(_contracts.Contract(
    id="engine.step",
    where="repro_torch.serve.engine.StreamingPCAEngine.step",
    claim="one chunk launch a step; the fleet state updated in place "
          "(every state tensor keeps its memory, the counterpart of "
          "donation); no host read in the step but the retirement pull",
    run=_engine_runs,
    rules=_ENGINE_RULES,
    cuda_rules=(_ol.SyncBudget(),),
))


def _pipelined_ledger(records):
    rows = []
    for label, rec in records.items():
        r = rec.result
        cid = "engine.step.pipelined"
        rows += [
            _contracts.RuleResult(
                cid, f"hot-loop:no-host-pull[{label}]", r["pulls"]["hot"] == 0,
                f"{r['pulls']['hot']} pulls in the hot path over "
                f"{r['steps']} steps (want 0)"),
            _contracts.RuleResult(
                cid, f"hot-loop:retire-pulls[{label}]",
                r["pulls"]["retire"] > 0,
                f"retirement pulled {r['pulls']['retire']} times (want > 0: "
                f"the loop's only device-to-host copies)"),
            _contracts.RuleResult(
                cid, f"hot-loop:prestage[{label}]", r["prestage_hits"] >= 1,
                f"{r['prestage_hits']} prestaged chunks used, "
                f"{r['prestage_misses']} staged inline (want >= 1 hit)")]
    return rows


_contracts.register(_contracts.Contract(
    id="engine.step.pipelined",
    where="repro_torch.serve.engine.StreamingPCAEngine.step",
    claim="the pipelined loop keeps the step's contract, pulls nothing in "
          "the hot path, pulls at retirement only and uses its prestaged "
          "chunks",
    run=lambda dev: _engine_runs(dev, pipeline=True),
    rules=_ENGINE_RULES,
    runtime=_pipelined_ledger,
    cuda_rules=(_ol.SyncBudget(),),
))
