"""Serving engines: LLM prefill/decode with continuous batching, and a
micro-batching front-end for matrix-specialized SpTRSV solves (the JAX
package's ``serve/engine.py``).

A fixed pool of ``B`` decode slots; finished sequences are replaced from
the admission queue each step.  Per-slot state lives in one batched KV
cache; a joining request is prefilled alone (batch 1) and every leaf of
its per-layer cache (``k``, ``v``, ``scale``; the recurrent states ``h``,
``C``, ``n``, ``m``, ``c``; ``conv``), and whisper's encoder output
``enc_out``, is copied into its slot.  As in the JAX engine, every slot decodes at one
shared position, the largest ``idx`` of the requests joined so far, so a
slot that joins later with a shorter prompt decodes past its own length.

Whisper and paligemma requests carry their modality stub in
``Request.extras`` (``{"enc_embed": (Se, D)}`` frames, the same ``Se`` for
every request of one engine, or ``{"patches": (prefix_len, D)}``), which
the request's prefill takes; a request without its model's stub, or with
another, is refused at ``submit``.  The JAX engine prefills the tokens
alone and cannot serve these two (ROADMAP C-ref 10).

The SpTRSV half of this module is the **per-factor worker** of the
multi-tenant solve service: :class:`SolveEngine` owns one factor pair
(forward + optional transpose), micro-batches same-direction requests into
power-of-base width buckets, isolates per-request failures, and supports
atomic solver promotion (:meth:`SolveEngine.swap_solvers`) so a
:class:`repro_torch.serve.SolverRegistry` can replace the cheap cold serial
pair with the planned build without dropping queued requests.  The
:class:`repro_torch.serve.SolveService` composes one engine per resident
sparsity pattern and continuously batches requests *across* tenants
through them.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import TYPE_CHECKING, List, Optional

import numpy as np
import torch

from ..kernels.cuda_common import KernelLaunchError

if TYPE_CHECKING:  # SolveEngine must stay importable without the model stack
    from ..models.model import Model

__all__ = ["Request", "ServeEngine", "SolveRequest", "SolveEngine"]


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray              # (P,) int32
    max_new: int = 16
    out: Optional[list] = None
    done: bool = False
    extras: Optional[dict] = None   # modality stub (enc_embed / patches)


class ServeEngine:
    def __init__(self, model: Model, params: dict, *, batch_slots: int = 4,
                 s_cache: int = 128, eos_id: int = -1):
        self.model = model
        self.params = params
        self.B = batch_slots
        self.s_cache = s_cache
        self.eos = eos_id
        self.queue: deque = deque()
        self.slots: List[Optional[Request]] = [None] * batch_slots
        self.remaining = np.zeros(batch_slots, np.int32)
        self._decode = model.decode_step
        self._prefill = lambda p, tokens, **stub: model.prefill(
            p, tokens, self.s_cache, **stub)
        self.cache = model.init_cache(batch_slots, s_cache)
        self.enc_len: Optional[int] = None      # Se of every audio request
        self.tokens = torch.zeros((batch_slots, 1), dtype=torch.long,
                                  device=model.device)
        self.steps = 0
        self.prefills = 0

    # -- admission ------------------------------------------------------------
    def submit(self, req: Request):
        """Queue ``req``; ``ValueError`` unless its ``extras`` hold exactly
        the model's stub, one 2-D array (an audio request's frames as many
        as the engine's other requests')."""
        stub = self.model.stub
        given = sorted(req.extras or {})
        if given != ([stub] if stub else []):
            raise ValueError(f"request {req.rid}: {self.model.cfg.name} takes "
                             f"extras {[stub] if stub else []}, got {given}")
        if stub:
            shape = np.shape(req.extras[stub])
            if len(shape) != 2:
                raise ValueError(f"request {req.rid}: {stub} {shape} is not 2-D")
            if stub == "enc_embed":
                if self.enc_len is None:
                    self.enc_len = shape[0]
                elif shape[0] != self.enc_len:
                    raise ValueError(f"request {req.rid}: {shape[0]} encoder "
                                     f"frames, the engine's requests have "
                                     f"{self.enc_len}")
        req.out = []
        self.queue.append(req)

    def _join(self, slot: int, req: Request):
        """Prefill a single joining request (with its stub) and copy every
        leaf of its per-layer cache, and its ``enc_out``, into ``slot`` of
        the batched cache."""
        dev = self.model.device
        prompt = torch.as_tensor(np.asarray(req.prompt)[None], dtype=torch.long,
                                 device=dev)
        stub = {name: torch.as_tensor(np.asarray(a, np.float32)[None], device=dev)
                for name, a in (req.extras or {}).items()}
        logits, cache1 = self._prefill(self.params, prompt, **stub)
        self.prefills += 1
        for big, small in zip(self.cache["layers"], cache1["layers"]):
            for name, leaf in small.items():
                big[name][slot] = leaf[0]
        if "enc_out" in cache1:
            enc = cache1["enc_out"]
            if self.cache["enc_out"].shape[1:] != enc.shape[1:]:
                self.cache["enc_out"] = enc.new_zeros((self.B, *enc.shape[1:]))
            self.cache["enc_out"][slot] = enc[0]
        self.cache["idx"] = max(self.cache["idx"], cache1["idx"])
        tok = int(logits[0, -1].argmax())
        self.tokens[slot, 0] = tok
        self.slots[slot] = req
        self.remaining[slot] = req.max_new
        req.out.append(tok)

    # -- main loop -------------------------------------------------------------
    def step(self):
        for i in range(self.B):
            if self.slots[i] is None and self.queue:
                self._join(i, self.queue.popleft())
        if all(s is None for s in self.slots):
            return False
        logits, self.cache = self._decode(self.params, self.tokens, self.cache)
        nxt = logits[:, 0].argmax(-1)
        self.tokens = nxt[:, None]
        self.steps += 1
        for i, tok in enumerate(nxt.tolist()):
            req = self.slots[i]
            if req is None:
                continue
            req.out.append(tok)
            self.remaining[i] -= 1
            if self.remaining[i] <= 0 or tok == self.eos:
                req.done = True
                self.slots[i] = None
        return True

    def run(self, max_steps: int = 1000):
        while self.step() and self.steps < max_steps:
            pass


# ==========================================================================
# Batched SpTRSV serving
# ==========================================================================
@dataclasses.dataclass
class SolveRequest:
    """One RHS vector to solve against the engine's fixed factor L.

    ``transpose=True`` requests the backward sweep ``Lᵀ x = b`` (requires the
    engine to hold a transpose solver).

    On completion exactly one of ``x`` / ``error`` is set: a request whose
    solve raised (e.g. a guarded solver's ``GuardBreakdownError``, or a
    non-finite RHS) carries the exception in ``error`` with ``done=True``
    and ``x=None`` — failures are isolated per request, they never poison
    co-batched neighbours (see ``SolveEngine._solve_group``).  ``b`` and
    ``x`` are host numpy arrays.

    ``tenant`` is an opaque caller tag the multi-tenant
    :class:`repro_torch.serve.SolveService` uses for per-tenant accounting;
    the engine itself never branches on it."""

    rid: int
    b: np.ndarray                   # (n,)
    transpose: bool = False
    tenant: Optional[str] = None
    x: Optional[np.ndarray] = None  # set when done (unless error)
    done: bool = False
    error: Optional[Exception] = None


class SolveEngine:
    """Micro-batching front-end for a matrix-specialized :class:`SpTRSV`.

    The paper's economics — expensive per-matrix analysis amortized over many
    solves of the same L — extend to serving: requests that share L are
    drained from an admission queue and solved as one multi-RHS batch
    ``L X = B``, so per-level launch overhead and the lane underfill of thin
    levels amortize over the batch width.

    An optional ``solver_t`` (typically the second half of
    ``SpTRSV.build_pair``) serves transpose requests ``Lᵀ x = b``; each
    drained step batches the two directions separately (they are distinct
    specialized executors) but drains them from one queue.

    Batch widths are rounded up to the next bucket (powers of
    ``bucket_base`` up to ``max_batch``, padding columns with zeros), as in
    the JAX engine.  A batch is built on the host at the solver's dtype,
    one row per request (each request's copy is contiguous; the transpose
    to the solver's ``(n, m)`` runs on its device), moved to the solver's
    device once, solved, and moved back once.  A
    bucket of width 1 — a lone request, and every per-request re-solve of
    the failure fallback — is solved as an ``(n,)`` vector, which is what
    reaches the single-RHS kernels (the fused walk; the level kernel in
    place of its batched twin); an ``(n, 1)`` buffer would run the batched
    ones for one column.

    :meth:`refresh` swaps in new factor **values** of the same sparsity
    pattern across both directions (``SpTRSV.refresh``): the symbolic
    schedule, permutation, kernel tables and device buffers are all
    reused, so a serving tier re-doing numeric factorization (each PCG/IC
    refactor step) pays one O(nnz) value re-pack instead of a rebuild.
    """

    def __init__(self, solver, solver_t=None, *, max_batch: int = 64,
                 bucket_base: int = 2):
        # real ValueErrors, not asserts: a serving tier runs under
        # ``python -O`` too, and a stripped assert here would let a
        # mis-sized engine silently corrupt batch buffers downstream
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1; got {max_batch}")
        if solver_t is not None and solver_t.n != solver.n:
            raise ValueError(
                f"solver_t solves a {solver_t.n}-row system but solver "
                f"solves {solver.n} rows — the pair must share one factor")
        self.solver = solver
        self.solver_t = solver_t
        self.max_batch = max_batch
        self.bucket_base = max(2, bucket_base)
        self.queue: deque = deque()
        self.solved = 0
        self.failed = 0
        self.batches = 0
        self._next_rid = 0

    @classmethod
    def from_matrix(cls, L, *, strategy: str = "auto", transpose_too: bool = True,
                    max_batch: int = 64, bucket_base: int = 2, **build_kwargs):
        """Stand up a serving engine straight from a factor.

        Defaults to ``strategy="auto"`` — the transform planner picks the
        executor, whether to coarsen the schedule, AND whether to rewrite
        the matrix first (``thin`` vs ``critical_path`` policy) per matrix,
        which is the right default for a serving tier that sees arbitrary
        factors.  ``transpose_too=True`` builds the backward solver from the
        same shared analysis (``SpTRSV.build_pair``) so transpose requests
        are servable.  Extra keyword arguments (``device=``, ``rewrite=``,
        ``coarsen=``, ``bucket_pad_ratio=``, ...) pass through to
        ``SpTRSV.build``; an explicit ``rewrite=`` overrides the planner's transform
        choice, and ``device=`` (default ``"cuda"``) is where the solvers
        run."""
        from ..core import SpTRSV

        if transpose_too:
            fwd, bwd = SpTRSV.build_pair(L, strategy=strategy, **build_kwargs)
        else:
            fwd, bwd = SpTRSV.build(L, strategy=strategy, **build_kwargs), None
        return cls(fwd, bwd, max_batch=max_batch, bucket_base=bucket_base)

    def stats(self) -> dict:
        """Serving-tier view of the engine: per-direction solver stats
        (strategy, layout, packed bytes, rewrite policy, planner decision —
        see ``SpTRSV.stats``) plus queue/batch counters, so a deployment
        dashboard reads one dict instead of poking solver internals."""
        return {
            "forward": self.solver.stats(),
            "backward": self.solver_t.stats() if self.solver_t else None,
            "queue_depth": len(self.queue),
            "solved": self.solved,
            "failed": self.failed,
            "batches": self.batches,
            "max_batch": self.max_batch,
        }

    def swap_solvers(self, solver, solver_t=None) -> None:
        """Atomically replace the engine's solver pair (the registry's
        cold-to-planned *promotion*).  The replacement must solve the same
        system size and keep the transpose direction servable if the engine
        already serves it — queued transpose requests must not be stranded.
        In-flight batches are unaffected: ``_solve_group`` reads the solver
        reference once at drain time."""
        if solver.n != self.solver.n:
            raise ValueError(
                f"promoted solver solves {solver.n} rows but this engine "
                f"serves a {self.solver.n}-row factor")
        if self.solver_t is not None and solver_t is None:
            raise ValueError(
                "engine serves transpose requests but the promoted pair "
                "has no transpose solver")
        if solver_t is not None and solver_t.n != solver.n:
            raise ValueError(
                f"promoted solver_t solves {solver_t.n} rows but solver "
                f"solves {solver.n} rows — the pair must share one factor")
        self.solver = solver
        if solver_t is not None:
            self.solver_t = solver_t

    def refresh(self, new_values, *, validate: bool = True) -> "SolveEngine":
        """Value-only numeric refresh of the engine's factor: new ``data``
        for the same sparsity pattern (array aligned with the original L's
        CSR storage, or a pattern-identical ``CSRMatrix``).

        The queue is **drained first**: every request already submitted is
        solved against the factor it was submitted against, then the values
        swap in for subsequent solves (reusing the kernel tables and device
        buffers via ``SpTRSV.refresh``).  Without the drain, in-flight
        requests would silently be answered with a factor that did not exist
        when they were enqueued.

        ``validate`` forwards to ``SpTRSV.refresh``'s O(nnz) value health
        scan (finiteness + zero-pivot); ``validate=False`` admits suspect
        values and leaves them to a guarded solver's breakdown policy."""
        self.run()
        self.solver.refresh(new_values, validate=validate)
        if self.solver_t is not None:
            self.solver_t.refresh(new_values, validate=validate)
        return self

    def submit(self, b: np.ndarray, *, transpose: bool = False,
               tenant: Optional[str] = None) -> SolveRequest:
        b = np.asarray(b)
        # real checks, not asserts: stripped under ``python -O``, a
        # wrong-length RHS would silently write a truncated/broadcast column
        # into the batch buffer and corrupt every co-batched neighbour
        if b.ndim != 1 or b.shape[0] != self.solver.n:
            raise ValueError(
                f"RHS must be a ({self.solver.n},) vector; got shape "
                f"{b.shape}")
        if transpose and self.solver_t is None:
            raise ValueError(
                "transpose request but engine was built without a "
                "transpose solver (pass solver_t= or transpose_too=True)")
        req = SolveRequest(rid=self._next_rid, b=b, transpose=transpose,
                           tenant=tenant)
        self._next_rid += 1
        self.queue.append(req)
        return req

    def _bucket(self, width: int) -> int:
        """Smallest power-of-base bucket >= width, capped at max_batch."""
        m = 1
        while m < width:
            m *= self.bucket_base
        return min(m, self.max_batch)

    @staticmethod
    def _dispatch(solver, B: np.ndarray) -> np.ndarray:
        """One executor dispatch: the host buffer ``B`` at the solver's
        dtype — an ``(n,)`` vector, or ``(m, n)`` with one right-hand side
        per row — moved to the solver's device, solved, and the answer
        moved back in the same layout."""
        b = torch.from_numpy(B).to(solver.device)
        if b.dim() == 1:
            return solver.solve(b).cpu().numpy()
        return solver.solve(b.T).T.contiguous().cpu().numpy()

    def _solve_group(self, solver, reqs) -> None:
        m = self._bucket(len(reqs))
        # the batch buffer is allocated in the SOLVER's dtype, not
        # result_type over the requests: one float64 request must not
        # up-cast an f32 solver's whole bucket
        if m == 1:
            B = np.array(reqs[0].b, dtype=solver.dtype)
        else:
            B = np.zeros((m, solver.n), dtype=solver.dtype)
            for j, r in enumerate(reqs):
                B[j] = r.b
        try:
            X = self._dispatch(solver, B)
        except KernelLaunchError:
            raise   # the card's state is suspect: no per-request retry
        except Exception:
            # One bad RHS (or one guarded column over tolerance under
            # on_breakdown="raise") must not poison the whole micro-batch:
            # re-solve each request alone so healthy co-batched neighbours
            # still get answers and only the culprits carry the exception.
            # Each re-solve is a width-1 bucket (an (n,) vector at the
            # solver's dtype) and counts in ``batches`` like every other
            # executor dispatch, so the counters stay consistent between
            # the happy and fallback paths (1 failed batched attempt +
            # len(reqs) width-1 re-solves).
            self.batches += 1
            for r in reqs:
                try:
                    r.x = self._dispatch(solver,
                                         np.array(r.b, dtype=solver.dtype))
                except KernelLaunchError:
                    raise
                except Exception as exc:
                    r.error = exc
                self.batches += 1
                r.done = True
            return
        if m == 1:
            reqs[0].x = X
            reqs[0].done = True
        else:
            for j, r in enumerate(reqs):
                r.x = X[j]
                r.done = True
        self.batches += 1

    def step(self) -> int:
        """Drain up to ``max_batch`` queued requests, batched per direction
        (forward / transpose).  Returns the number of requests completed
        (0 if the queue is empty).  Requests that complete with ``error``
        set count in ``failed``, not ``solved`` — ``stats()["solved"]``
        must mean answers, not attempts, or a breakdown-heavy tenant would
        read as healthy throughput on the dashboard.  A
        :class:`~repro_torch.kernels.cuda_common.KernelLaunchError`
        propagates: it is the card's fault, not a request's."""
        if not self.queue:
            return 0
        take = min(len(self.queue), self.max_batch)
        reqs = [self.queue.popleft() for _ in range(take)]
        fwd = [r for r in reqs if not r.transpose]
        bwd = [r for r in reqs if r.transpose]
        if fwd:
            self._solve_group(self.solver, fwd)
        if bwd:
            self._solve_group(self.solver_t, bwd)
        ok = sum(1 for r in reqs if r.error is None)
        self.solved += ok
        self.failed += take - ok
        return take

    def run(self) -> int:
        """Solve everything queued; returns total completed."""
        total = 0
        while self.queue:
            total += self.step()
        return total
