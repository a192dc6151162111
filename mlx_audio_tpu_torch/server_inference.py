"""Device-work broker: one thread owns all accelerator dispatch.

The port's own copy of mlx_audio_tpu/server_inference.py (standard library
only): the request, handle and chunk types, the adapter protocols and
`InferenceBroker`, whose one worker thread serialises every call into the
models (PyTorch launches are asynchronous, so the thread mostly enqueues
device work and streams results back through per-request queues).

Routing policy: continuous-batch sessions are stepped before any
whole-request work, and serial/batch requests wait until all continuous
sessions drain. Idle sessions are kept warm for an idle TTL
(MLX_AUDIO_SESSION_IDLE_TTL_S, default 60 s) and reused through their
`reset_timeline`.
"""

from __future__ import annotations

import os
import queue
import threading
import time
import traceback
import uuid
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Protocol


@dataclass
class InferenceResultChunk:
    kind: str  # "data" | "error" | "done"
    payload: Any = None
    error: Optional[BaseException] = None


@dataclass
class InferenceContext:
    request_id: str
    endpoint_kind: str
    model_name: str
    queued_at: float
    batch_key: Any = None


@dataclass
class InferenceRequest:
    endpoint_kind: str
    model_name: str
    payload: Any
    normalized_kwargs: Dict[str, Any] = field(default_factory=dict)
    stream: bool = False
    batch_key: Any = None
    request_id: str = field(default_factory=lambda: uuid.uuid4().hex)
    queued_at: float = field(default_factory=time.time)
    result_queue: "queue.Queue[InferenceResultChunk]" = field(
        default_factory=queue.Queue)
    cancel_event: threading.Event = field(default_factory=threading.Event)

    def emit_data(self, payload: Any) -> None:
        self.result_queue.put(InferenceResultChunk("data", payload=payload))

    def emit_error(self, error: BaseException) -> None:
        self.result_queue.put(InferenceResultChunk("error", error=error))

    def emit_done(self) -> None:
        self.result_queue.put(InferenceResultChunk("done"))


@dataclass
class InferenceHandle:
    context: InferenceContext
    result_queue: "queue.Queue[InferenceResultChunk]"
    cancel_event: threading.Event

    def cancel(self) -> None:
        self.cancel_event.set()


class ModelExecutionAdapter(Protocol):
    max_batch_size: int

    def supports_batch(self, request: InferenceRequest) -> bool: ...

    def batch_key(self, request: InferenceRequest) -> Any: ...

    def run_serial(self, request: InferenceRequest) -> None: ...

    def run_batch(self, requests: List[InferenceRequest]) -> None: ...

    def supports_continuous_batch(self, request: InferenceRequest) -> bool: ...

    def continuous_batch_key(self, request: InferenceRequest) -> Any: ...

    def create_continuous_batch_session(self, request: InferenceRequest): ...


class ContinuousBatchSession(Protocol):
    @property
    def idle(self) -> bool: ...

    def submit(self, request: InferenceRequest) -> None: ...

    def step(self) -> None: ...

    def fail(self, error: BaseException) -> None: ...


class BaseModelExecutionAdapter:
    """Default adapter: serial-only."""

    max_batch_size = 1

    def supports_batch(self, request) -> bool:
        return False

    def batch_key(self, request) -> Any:
        return None

    def run_serial(self, request) -> None:
        raise NotImplementedError

    def run_batch(self, requests) -> None:
        if len(requests) != 1:
            raise NotImplementedError
        self.run_serial(requests[0])

    def supports_continuous_batch(self, request) -> bool:
        return False

    def continuous_batch_key(self, request) -> Any:
        return self.batch_key(request)

    def create_continuous_batch_session(self, request):
        raise NotImplementedError


class InferenceBroker:
    """Single worker thread that owns all device work."""

    def __init__(self, *, idle_poll_s: float = 0.05):
        self.idle_poll_s = idle_poll_s
        self._inbox: "queue.Queue[Optional[InferenceRequest]]" = queue.Queue()
        self._adapters: Dict[str, ModelExecutionAdapter] = {}
        self._sessions: Dict[Any, ContinuousBatchSession] = {}
        # idle sessions are kept warm for a while: their device buffers
        # make the next burst's first step cheap (a fresh session pays its
        # allocations and first-call set-up there)
        self._session_idle_since: Dict[Any, float] = {}
        self.session_idle_ttl_s = float(
            os.environ.get("MLX_AUDIO_SESSION_IDLE_TTL_S", "60"))
        self._stop = threading.Event()
        self._worker = threading.Thread(target=self._loop, daemon=True)
        self._worker.start()

    # -- public ------------------------------------------------------------

    def register_adapter(self, endpoint_kind: str,
                         adapter: ModelExecutionAdapter) -> None:
        self._adapters[endpoint_kind] = adapter

    def submit(self, *, endpoint_kind: str, model_name: str, payload: Any,
               normalized_kwargs: Optional[dict] = None, stream: bool = False,
               batch_key: Any = None) -> InferenceHandle:
        adapter = self._adapters.get(endpoint_kind)
        if adapter is None:
            raise ValueError(
                f"No inference adapter registered for {endpoint_kind!r}")
        req = InferenceRequest(
            endpoint_kind=endpoint_kind, model_name=model_name,
            payload=payload, normalized_kwargs=normalized_kwargs or {},
            stream=stream, batch_key=batch_key)
        if req.batch_key is None:
            req.batch_key = adapter.batch_key(req)
        self._inbox.put(req)
        return InferenceHandle(
            context=InferenceContext(
                request_id=req.request_id, endpoint_kind=req.endpoint_kind,
                model_name=req.model_name, queued_at=req.queued_at,
                batch_key=req.batch_key),
            result_queue=req.result_queue,
            cancel_event=req.cancel_event)

    def stop_and_join(self, timeout: float = 5.0) -> None:
        self._stop.set()
        self._inbox.put(None)
        self._worker.join(timeout=timeout)
        for adapter in self._adapters.values():
            shutdown = getattr(adapter, "shutdown", None)
            if callable(shutdown):
                shutdown()

    # -- worker loop --------------------------------------------------------

    def _loop(self) -> None:
        backlog: List[InferenceRequest] = []
        try:
            while not self._stop.is_set():
                self._drain_inbox(
                    backlog,
                    block=not backlog and not any(
                        not s.idle for s in self._sessions.values()))
                backlog = [r for r in backlog if not r.cancel_event.is_set()]

                backlog = self._admit_to_sessions(backlog)
                self._tick_sessions()
                if any(not s.idle for s in self._sessions.values()):
                    # continuous work gets priority; serial waits for drain
                    # (idle-retained warm sessions don't block serial work)
                    continue
                if not backlog:
                    continue

                head = backlog.pop(0)
                adapter = self._adapters.get(head.endpoint_kind)
                if adapter is None:
                    head.emit_error(ValueError(
                        f"No inference adapter registered for "
                        f"{head.endpoint_kind!r}"))
                    head.emit_done()
                    continue

                group = [head]
                if adapter.supports_batch(head) and adapter.max_batch_size > 1:
                    group += self._take_batchable(head, adapter, backlog)
                try:
                    if len(group) > 1:
                        adapter.run_batch(group)
                    else:
                        adapter.run_serial(head)
                except Exception as exc:
                    traceback.print_exc()
                    for r in group:
                        r.emit_error(exc)
                        r.emit_done()
        finally:
            for session in list(self._sessions.values()):
                session.fail(RuntimeError("Inference broker stopped."))
            self._sessions.clear()

    def _drain_inbox(self, backlog: List[InferenceRequest], *,
                     block: bool) -> None:
        try:
            first = (self._inbox.get(timeout=self.idle_poll_s) if block
                     else self._inbox.get_nowait())
        except queue.Empty:
            return
        items = [first]
        while True:
            try:
                items.append(self._inbox.get_nowait())
            except queue.Empty:
                break
        for item in items:
            if item is None:
                self._stop.set()
            else:
                backlog.append(item)

    def _take_batchable(self, head: InferenceRequest,
                        adapter: ModelExecutionAdapter,
                        backlog: List[InferenceRequest]) -> List[InferenceRequest]:
        taken, keep = [], []
        for r in backlog:
            if (len(taken) < adapter.max_batch_size - 1
                    and not r.cancel_event.is_set()
                    and r.endpoint_kind == head.endpoint_kind
                    and r.model_name == head.model_name
                    and r.batch_key == head.batch_key
                    and adapter.supports_batch(r)):
                taken.append(r)
            else:
                keep.append(r)
        backlog[:] = keep
        return taken

    def _admit_to_sessions(
            self, backlog: List[InferenceRequest]) -> List[InferenceRequest]:
        keep: List[InferenceRequest] = []
        for r in backlog:
            adapter = self._adapters.get(r.endpoint_kind)
            if adapter is None or not adapter.supports_continuous_batch(r):
                keep.append(r)
                continue
            key = (r.endpoint_kind, r.model_name,
                   adapter.continuous_batch_key(r))
            session = self._sessions.get(key)
            try:
                if session is not None and session.idle:
                    # reuse the warm session: its device buffers survive,
                    # so the burst's first step skips the fresh session's
                    # set-up cost
                    reset = getattr(session, "reset_timeline", None)
                    if callable(reset):
                        try:
                            reset()
                        except Exception:
                            session = None
                    else:
                        session = None
                if session is None:
                    session = adapter.create_continuous_batch_session(r)
                    self._sessions[key] = session
                self._session_idle_since.pop(key, None)
                session.submit(r)
            except Exception as exc:
                traceback.print_exc()
                r.emit_error(exc)
                r.emit_done()
        return keep

    def _tick_sessions(self) -> None:
        now = time.monotonic()
        for key, session in list(self._sessions.items()):
            if session.idle:
                # retained warm: expire after the idle TTL
                since = self._session_idle_since.setdefault(key, now)
                if now - since > self.session_idle_ttl_s:
                    self._sessions.pop(key, None)
                    self._session_idle_since.pop(key, None)
                continue
            self._session_idle_since.pop(key, None)
            try:
                session.step()
            except Exception as exc:
                traceback.print_exc()
                session.fail(exc)
                self._sessions.pop(key, None)
                self._session_idle_since.pop(key, None)
