"""Continuous-batched LLM serving engine (port of ray_tpu/serve/llm.py).

- paged KV cache by default (models/paged_decode.py), dense slots with
  ``paged=False`` (models/decode.py);
- CONTINUOUS batching: new requests are prefilled into free slots while
  other slots keep decoding, with no batch barrier;
- prefill is bucketed (prompt padded to the next bucket), and the paged
  engine prefills each bucket's prompts together, padded to a fixed batch;
- decode runs ``decode_chunk`` ticks per loop iteration and hands the
  chunk's tokens (plus any first tokens from this round's prefills) to the
  host with ONE device-to-host copy;
- per-request TTFT and latency; engine ``stats``; streaming;
- every loop iteration that does work is recorded through
  ``ray_tpu_torch.profiling`` as spans on ``time.time()``, the clock
  ``torch.profiler`` puts device activity on: ``engine.step`` is tiled by
  ``engine.admit`` (which holds each ``engine.prefill`` program, with its
  ``bucket``, ``rows`` and prompt ``lengths``, and that program's
  ``engine.h2d`` copies), ``engine.decode`` (enqueueing the chunk),
  ``engine.d2h`` (the host waiting for the chunk's tokens) and
  ``engine.deliver``; ``engine.step`` carries the chunk's ``ticks``. Each
  request adds ``request.queue``, from its submission to the start of the
  prefill program that takes it. Every span carries the engine's id and the
  iteration (``step``); an idle poll records nothing.

The loop runs on a background thread. ``torch.inference_mode`` is
thread-local, so the loop enters it itself. The loop logs and survives any
exception, so a kernel that fails leaves requests waiting: callers pass a
``timeout`` to ``generate``.

``LLMDeployment`` wraps the engine as a serve deployment; requests are
dicts {"tokens": [...], "max_tokens": N} -> {"tokens": [...], "ttft_s": ...}.
"""

from __future__ import annotations

import itertools
import queue
import threading
import time
from collections import deque
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ray_tpu_torch import profiling
from ray_tpu_torch._device import resolve_device
from ray_tpu_torch.utils.logging import get_logger

logger = get_logger("serve.llm")

_request_ids = itertools.count(1)
_engine_ids = itertools.count(1)


@dataclass
class GenRequest:
    tokens: List[int]
    max_tokens: int
    eos_token: Optional[int]
    future: Future
    submitted_at: float = field(default_factory=time.perf_counter)
    id: int = field(default_factory=lambda: next(_request_ids))
    ttft_s: Optional[float] = None
    out_tokens: List[int] = field(default_factory=list)
    slot: int = -1
    pending_first: Any = None  # device scalar: first sampled token, unfetched
    # streaming: tokens pushed here as decoded (None sentinel = done)
    stream_q: Optional["queue.Queue"] = None
    streamed: int = 0
    cancelled: bool = False


def _params_to(tree, device):
    if isinstance(tree, dict):
        return {k: _params_to(v, device) for k, v in tree.items()}
    return tree.to(device)


class LLMEngine:
    """Continuous-batching loop around models/paged_decode.py (paged KV
    cache, the default) or models/decode.py (dense slots). Runs on
    ``device`` ("cuda" unless the caller passes "cpu"); with no card and no
    ``device="cpu"`` it raises."""

    def __init__(self, config, params=None, *, device=None, num_slots: int = 8,
                 max_seq_len: Optional[int] = None, decode_chunk: int = 8,
                 temperature: float = 0.0, prefill_buckets: Optional[List[int]] = None,
                 paged: bool = True, page_size: int = 64,
                 total_pages: Optional[int] = None):
        from ray_tpu_torch.models.decode import init_kv_cache, make_decode_fn, make_prefill_fn
        from ray_tpu_torch.models.llama import llama_init

        self.device = resolve_device(device)
        self.config = config
        self.num_slots = num_slots
        self.max_seq = max_seq_len or config.max_seq_len
        self.decode_chunk = decode_chunk
        self.params = (_params_to(params, self.device) if params is not None
                       else llama_init(config, 0, self.device))
        self.paged = paged
        dev = self.device
        if paged:
            from ray_tpu_torch.models.paged_decode import (
                PageAllocator,
                check_layer,
                check_page_size,
                init_paged_cache,
                kernel_tiles,
                make_paged_decode_fn,
                make_paged_prefill_fn,
            )

            if dev.type == "cuda" and kernel_tiles(config.head_dim_, config.dtype):
                # the decode kernel's limits, at construction, not at the first tick
                check_layer(config.head_dim_, config.num_heads, config.num_kv_heads,
                            config.dtype)
                if config.dtype == torch.bfloat16:  # the TMA kernel's page boxes
                    check_page_size(page_size)
            self.page_size = page_size
            self.pages_per_slot = -(-self.max_seq // page_size)
            # default pool: dense-equivalent capacity (+1 trash page)
            self.total_pages = total_pages or (1 + num_slots * self.pages_per_slot)
            self.allocator = PageAllocator(self.total_pages)
            self.cache = init_paged_cache(config, self.total_pages, page_size,
                                          dtype=config.dtype, device=dev)
            self._table = torch.zeros((num_slots, self.pages_per_slot), dtype=torch.int32,
                                      device=dev)
            self._slot_pages: List[Optional[List[int]]] = [None] * num_slots
            self._prefill = make_paged_prefill_fn(config, page_size)
            self._decode = make_paged_decode_fn(config, decode_chunk, page_size, temperature)
        else:
            self.cache = init_kv_cache(config, num_slots, self.max_seq, dtype=config.dtype,
                                       device=dev)
            self._prefill = make_prefill_fn(config)
            self._decode = make_decode_fn(config, decode_chunk, temperature)
        self.prefill_buckets = sorted({
            min(b, self.max_seq) for b in (prefill_buckets or [128, 512, 2048])
        })
        if paged:
            # buckets are page multiples so prompt K/V scatter is a reshape
            self.prefill_buckets = sorted({
                -(-b // page_size) * page_size for b in self.prefill_buckets
            })
        self._gen = torch.Generator(device=dev).manual_seed(0)
        # device-side batch state
        self._tokens = torch.zeros((num_slots,), dtype=torch.int32, device=dev)
        self._positions = torch.zeros((num_slots,), dtype=torch.int32, device=dev)
        self._active = torch.zeros((num_slots,), dtype=torch.bool, device=dev)
        # host-side state
        self._slots: List[Optional[GenRequest]] = [None] * num_slots
        self._pending: "queue.Queue[GenRequest]" = queue.Queue()
        # head-of-line holding area for requests the page pool couldn't fit
        self._admit_backlog: "deque[GenRequest]" = deque()
        self._shutdown = False
        self._steps = 0
        self._tokens_out = 0
        self._prefill_programs = 0
        self._started = time.perf_counter()
        self._id = next(_engine_ids)
        self._iterations = 0  # working loop iterations recorded
        self._thread = threading.Thread(target=self._loop, daemon=True, name="llm-engine")
        self._thread.start()

    # ----------------------------------------------------------------- API
    def generate(self, tokens: List[int], max_tokens: int = 64,
                 eos_token: Optional[int] = None,
                 timeout: Optional[float] = None) -> Dict[str, Any]:
        """Blocking generate. Returns {"tokens", "ttft_s", "latency_s"}."""
        req = self._submit(tokens, max_tokens, eos_token)
        return req.future.result(timeout=timeout)

    def generate_stream(self, tokens: List[int], max_tokens: int = 64,
                        eos_token: Optional[int] = None,
                        timeout: Optional[float] = None):
        """Streaming generate: yields {"token": t} as each token is decoded,
        then a final {"done": True, "ttft_s", "latency_s", "num_tokens"}
        record. Abandoning the generator cancels the request."""
        req = self._submit(tokens, max_tokens, eos_token, stream=True)
        try:
            while True:
                tok = req.stream_q.get(timeout=timeout)
                if tok is None:
                    break
                yield {"token": tok}
            result = req.future.result(timeout=5.0)
            yield {"done": True, "ttft_s": result["ttft_s"],
                   "latency_s": result["latency_s"],
                   "num_tokens": len(result["tokens"])}
        finally:
            req.cancelled = True  # no-op if already finished

    def _submit(self, tokens, max_tokens, eos_token, stream: bool = False) -> GenRequest:
        if len(tokens) + max_tokens > self.max_seq:
            raise ValueError(
                f"prompt {len(tokens)} + max_tokens {max_tokens} exceeds "
                f"max_seq_len {self.max_seq}")
        req = GenRequest(tokens=list(tokens), max_tokens=max_tokens,
                         eos_token=eos_token, future=Future())
        if stream:
            req.stream_q = queue.Queue()
        self._pending.put(req)
        return req

    def stats(self) -> Dict[str, Any]:
        return {
            "slots": self.num_slots,
            "active": sum(r is not None for r in self._slots),
            "queued": self._pending.qsize() + len(self._admit_backlog),
            "decode_steps": self._steps,
            "prefill_programs": self._prefill_programs,
            "tokens_generated": self._tokens_out,
            "uptime_s": time.perf_counter() - self._started,
        }

    def stop(self) -> None:
        self._shutdown = True
        self._thread.join(timeout=10)

    # ---------------------------------------------------------------- loop
    def _bucket_for(self, n: int) -> int:
        for b in self.prefill_buckets:
            if n <= b:
                return b
        # longer than the largest configured bucket: round up to a 128
        # multiple rather than truncating the prompt
        bucket = min(self.max_seq, -(-n // 128) * 128)
        if self.paged:
            bucket = -(-bucket // self.page_size) * self.page_size
            bucket = min(bucket, self.pages_per_slot * self.page_size)
        return bucket

    def _admit(self) -> None:
        """Prefill waiting requests into free slots without a host sync: the
        first sampled token stays on the device and is fetched together with
        the next decode chunk."""
        if self.paged:
            self._admit_paged_batched()
            return
        while True:
            try:
                free = self._slots.index(None)
            except ValueError:
                return
            try:
                req = self._pending.get_nowait()
            except queue.Empty:
                return
            start, now = time.time(), time.perf_counter()
            self._span("request.queue", start - (now - req.submitted_at), start, request=req.id)
            n = len(req.tokens)
            bucket = self._bucket_for(n)
            padded = np.zeros((1, bucket), np.int32)
            padded[0, :n] = req.tokens
            copy = time.time()
            inputs = torch.from_numpy(padded).to(self.device)
            self._span("engine.h2d", copy, time.time())
            logits, self.cache = self._prefill(self.params, self.cache, inputs, free,
                                               min(n, bucket))
            self._prefill_programs += 1
            first = torch.argmax(logits).to(torch.int32)  # device scalar
            req.pending_first = first
            req.slot = free
            self._slots[free] = req
            self._tokens[free] = first
            self._positions[free] = n
            self._active[free] = True
            self._span("engine.prefill", start, time.time(), bucket=bucket, rows=1, lengths=[n])

    def _admit_paged_batched(self) -> None:
        """Pull every admissible request, group by prefill bucket, and run
        ONE batched prefill per group, padded to a fixed batch of
        min(8, num_slots) rows."""
        free_slots = [i for i, r in enumerate(self._slots) if r is None]
        admitted: List[tuple] = []  # (req, slot, pages, bucket)
        while free_slots:
            if self._admit_backlog:
                req = self._admit_backlog.popleft()
            else:
                try:
                    req = self._pending.get_nowait()
                except queue.Empty:
                    break
            n = len(req.tokens)
            bucket = self._bucket_for(n)
            need = max(bucket // self.page_size, -(-(n + req.max_tokens) // self.page_size))
            if need > self.allocator.total - 1:
                req.future.set_exception(ValueError(
                    f"request needs {need} KV pages but the pool has "
                    f"{self.allocator.total - 1}; raise total_pages or lower max_tokens"))
                if req.stream_q is not None:
                    req.stream_q.put(None)
                continue
            pages = self.allocator.alloc(need)
            if pages is None:
                # pool exhausted: hold at the HEAD of the line so a big
                # request is not starved by later small ones
                self._admit_backlog.appendleft(req)
                break
            admitted.append((req, free_slots.pop(0), pages, bucket))
        if not admitted:
            return
        by_bucket: Dict[int, List[tuple]] = {}
        for item in admitted:
            by_bucket.setdefault(item[3], []).append(item)
        size = min(8, self.num_slots)
        for bucket, group in by_bucket.items():
            for i in range(0, len(group), size):
                self._prefill_group(group[i:i + size], bucket, size)

    def _prefill_group(self, chunk: List[tuple], bucket: int, size: int) -> None:
        """One batched prefill for ``chunk`` (padded to ``size`` rows; pad
        rows write to the trash page and are discarded)."""
        start, now = time.time(), time.perf_counter()
        for req, *_ in chunk:
            self._span("request.queue", start - (now - req.submitted_at), start, request=req.id)
        dev = self.device
        n_pages = bucket // self.page_size
        tokens = np.zeros((size, bucket), np.int32)
        page_arr = np.zeros((size, n_pages), np.int32)  # pad rows -> trash
        lengths = np.ones((size,), np.int32)
        for row, (req, slot, pages, _b) in enumerate(chunk):
            n = len(req.tokens)
            tokens[row, :n] = req.tokens
            page_arr[row] = pages[:n_pages]
            lengths[row] = min(n, bucket)
        copy = time.time()
        inputs = [torch.from_numpy(a).to(dev) for a in (tokens, page_arr, lengths)]
        self._span("engine.h2d", copy, time.time())
        logits, self.cache = self._prefill(self.params, self.cache, *inputs)
        self._prefill_programs += 1
        firsts = torch.argmax(logits, dim=-1).to(torch.int32)  # [size], on device
        for row, (req, slot, pages, _b) in enumerate(chunk):
            self._slot_pages[slot] = pages
            trow = np.zeros((self.pages_per_slot,), np.int32)
            trow[: len(pages)] = pages
            copy = time.time()
            table_row = torch.from_numpy(trow).to(dev)
            self._span("engine.h2d", copy, time.time())
            self._table[slot] = table_row
            req.pending_first = firsts[row]
            req.slot = slot
            self._slots[slot] = req
            self._tokens[slot] = firsts[row]
            self._positions[slot] = len(req.tokens)
            self._active[slot] = True
        self._span("engine.prefill", start, time.time(), bucket=bucket, rows=size,
                   lengths=[len(item[0].tokens) for item in chunk])

    def _span(self, name: str, start: float, end: float, **extra) -> None:
        """Record a span of the iteration under way (``time.time()``
        seconds). Only a working iteration records, so it is the one after
        the last that did."""
        extra["engine"], extra["step"] = self._id, self._iterations + 1
        profiling.record_external_span(name, start, end, extra)

    def _push_stream(self, req: GenRequest) -> None:
        if req.stream_q is None:
            return
        while req.streamed < len(req.out_tokens):
            req.stream_q.put(req.out_tokens[req.streamed])
            req.streamed += 1

    def _finished(self, req: GenRequest) -> bool:
        if req.cancelled:
            return True
        if len(req.out_tokens) >= req.max_tokens:
            return True
        if req.eos_token is not None and req.out_tokens and \
                req.out_tokens[-1] == req.eos_token:
            return True
        if req.slot >= 0 and len(req.tokens) + len(req.out_tokens) >= self.max_seq:
            return True
        return False

    def _retire(self, slot: int) -> None:
        req = self._slots[slot]
        self._slots[slot] = None
        self._active[slot] = False
        if self.paged and self._slot_pages[slot] is not None:
            self.allocator.release(self._slot_pages[slot])
            self._slot_pages[slot] = None
            # table row back to the trash page so the retired slot's frozen
            # decode writes can't touch recycled pages
            self._table[slot] = 0
        if req is None:
            return
        if req.eos_token is not None and req.eos_token in req.out_tokens:
            req.out_tokens = req.out_tokens[: req.out_tokens.index(req.eos_token) + 1]
        self._tokens_out += len(req.out_tokens)
        self._push_stream(req)
        if req.stream_q is not None:
            req.stream_q.put(None)  # end-of-stream sentinel
        req.future.set_result({
            "tokens": req.out_tokens,
            "ttft_s": req.ttft_s,
            "latency_s": time.perf_counter() - req.submitted_at,
        })

    def _step(self) -> None:
        start = time.time()
        self._admit()
        if not any(r is not None for r in self._slots):
            time.sleep(0.01)  # idle: poll for work, record nothing
            return
        admitted = time.time()
        self._span("engine.admit", start, admitted)
        if self.paged:
            sampled, last, self._positions, self.cache = self._decode(
                self.params, self.cache, self._tokens, self._positions,
                self._active, self._table, self._gen)
        else:
            sampled, last, self._positions, self.cache = self._decode(
                self.params, self.cache, self._tokens, self._positions,
                self._active, self._gen)
        self._tokens = last
        self._steps += self.decode_chunk
        decoded = time.time()
        self._span("engine.decode", admitted, decoded)
        # ONE host copy per chunk: the chunk's tokens and any pending first
        # tokens from this round's prefills
        first_slots = [slot for slot, req in enumerate(self._slots)
                       if req is not None and req.pending_first is not None]
        flat = torch.cat([sampled.reshape(-1)]
                         + [self._slots[s].pending_first.reshape(1) for s in first_slots])
        host = flat.cpu().numpy()
        host_tokens = host[: sampled.numel()].reshape(sampled.shape)
        host_firsts = dict(zip(first_slots, host[sampled.numel():]))
        copied = time.time()
        self._span("engine.d2h", decoded, copied)
        now = time.perf_counter()
        for slot, first in host_firsts.items():
            req = self._slots[slot]
            req.pending_first = None
            req.ttft_s = now - req.submitted_at
            req.out_tokens.append(int(first))
            self._push_stream(req)  # first token streams immediately
        for slot, req in enumerate(self._slots):
            if req is None:
                continue
            if self._finished(req):
                self._retire(slot)
                continue
            for t in host_tokens[slot]:
                req.out_tokens.append(int(t))
                if self._finished(req):
                    break
            self._push_stream(req)
            if self._finished(req):
                self._retire(slot)
        end = time.time()
        self._span("engine.deliver", copied, end)
        self._span("engine.step", start, end, ticks=self.decode_chunk)
        self._iterations += 1

    def _loop(self) -> None:
        with torch.inference_mode():
            while not self._shutdown:
                try:
                    self._step()
                except Exception:  # noqa: BLE001 - engine loop must survive
                    logger.exception("llm engine loop error")
                    time.sleep(0.5)


class LLMDeployment:
    """Serve deployment wrapping LLMEngine. Construct via serve.deployment,
    with one card for the replica:

        app = serve.deployment(LLMDeployment, name="llm").options(
            ray_actor_options={"num_gpus": 1}).bind(model="llama_1b")
        handle = serve.run(app)
        handle.generate.remote({"tokens": [...], "max_tokens": 32}).result()

    ``device`` is the engine's: None means the card (it raises with no card
    present); the CPU only when asked for."""

    def __init__(self, model: str = "tiny", num_slots: int = 8,
                 decode_chunk: int = 8, max_seq_len: Optional[int] = None,
                 temperature: float = 0.0, params=None, device=None):
        from ray_tpu_torch.models.llama import LlamaConfig

        factories = {
            "tiny": LlamaConfig.tiny,
            "llama_1b": LlamaConfig.llama_1b,
            "llama3_8b": LlamaConfig.llama3_8b,
        }
        if model not in factories:
            raise ValueError(f"unknown model '{model}'; options: {sorted(factories)}")
        self.engine = LLMEngine(
            factories[model](), params, device=device, num_slots=num_slots,
            decode_chunk=decode_chunk, max_seq_len=max_seq_len, temperature=temperature)

    def __call__(self, request: Dict[str, Any]):
        if request.get("stream"):
            return self.generate_stream(request)
        return self.generate(request)

    def generate(self, request: Dict[str, Any]) -> Dict[str, Any]:
        return self.engine.generate(
            tokens=request["tokens"],
            max_tokens=int(request.get("max_tokens", 64)),
            eos_token=request.get("eos_token"),
            timeout=request.get("timeout"))

    def generate_stream(self, request: Dict[str, Any]):
        return self.engine.generate_stream(
            tokens=request["tokens"],
            max_tokens=int(request.get("max_tokens", 64)),
            eos_token=request.get("eos_token"),
            timeout=request.get("timeout"))

    def engine_stats(self) -> Dict[str, Any]:
        return self.engine.stats()

    def stop(self) -> None:
        self.engine.stop()

    def __del__(self):
        # the replica's graceful shutdown calls this before the actor goes
        try:
            self.engine.stop()
        except Exception:  # noqa: BLE001
            pass
