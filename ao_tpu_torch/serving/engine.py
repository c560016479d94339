"""Continuous-batching serving engine.

PyTorch port of ``ao_tpu/serving/engine.py``: the batch is a fixed pool of
``max_batch`` slots; requests queue, claim a slot, prefill once (prompt
lengths padded to a bucket, or chunked past the largest), and every
``step()`` advances all active slots with one decode forward. Per-slot
positions drive each row's cache writes and mask; inactive slots are
masked lanes. The KV memory is per-slot contiguous ``max_seq`` caches
(``kv_layout="slots"``) or a page pool with block tables
(``kv_layout="paged"``, ``serving/paged.py``), in bf16 or, with
``kv_quant``, quantized: int8, fp8 e4m3 or int4 in both layouts
(``QuantKVCache`` slots, quantized page pools) and fp8 e5m2 in slots only.
A quantized slot engine prefills into quantized scratch caches and copies
them into its slot (``insert_slot``); a quantized paged engine prefills
into bf16 scratch caches and quantizes them as it writes the pages, as the
reference does, so its first token comes from bf16 attention and the two
layouts' tokens differ.

On the card every bucketed prefill's attention runs the flash-attention
kernel (K8; over a quantized scratch, its dequantized values), every
slot-layout decode step a decode-attention kernel over per-slot lengths (K2
for bf16, K5 / K6 / K7 / K2v for int8 / e4m3 / int4 / e5m2), and every
paged decode step the paged-attention kernel K9 in the pool's mode ("fp",
"vec8" for int8 and e4m3, "int4"). The reference's jitted programs are
plain methods here that update the caches in place. Small per-slot state
(positions, current tokens, active flags, sampling parameters, the block
table) lives on the host in numpy; the slot layout keeps device mirrors of
the tokens, positions and active flags between steps, and each step reads
the picked tokens back once.

Sampling draws from one ``torch.Generator`` per engine, seeded with
``ServeConfig.seed``, in turn; the reference folds a step counter into one
key per device program, so sampled tokens differ from JAX's (greedy ones do
not).

Still to port, each refused with NotImplementedError naming its slice: the
prefix cache, multi-step decode (``decode_steps_per_call > 1``),
speculative decoding (``spec_draft``, a draft model), LoRA adapters,
penalties, logprobs and logit bias.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch


def _insert_tree(caches, scratch, slot: int) -> None:
    """Scratch (batch 1) prefill caches into slot ``slot`` of the pool, in
    place: rows [0, scratch length) of every layer's K and V; a
    ``QuantKVCache`` through its ``insert_slot``."""
    from ao_tpu_torch.serving.kvcache import QuantKVCache

    for pair, new in zip(caches, scratch):
        for pool, sc in zip(pair, new):
            if isinstance(pool, QuantKVCache):
                pool.insert_slot(sc, slot)
            else:
                pool[slot, :sc.shape[1]] = sc[0]


def _not_ported(what: str, slice_name: str) -> NotImplementedError:
    return NotImplementedError(f"{what} comes with the {slice_name} slice of the port")


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    max_batch: int = 8
    max_seq: int = 2048
    # None | "int8" | "float8_e4m3fn" | "int4" (slots or paged) | "float8_e5m2" (slots)
    kv_quant: Optional[str] = None
    eos_id: int = -1  # -1: never stop on a token
    prefill_buckets: Tuple[int, ...] = (128, 512, 2048)
    # KV memory layout: "slots" (per-slot contiguous max_seq caches) or
    # "paged" (page pool + block tables)
    kv_layout: str = "slots"
    page_size: int = 128
    num_pages: Optional[int] = None  # default: max_batch*max_seq/page_size+1
    prefix_cache: bool = False
    decode_steps_per_call: int = 1
    spec_draft: int = 0
    # sampling (0.0 = greedy); one generator per engine
    temperature: float = 0.0
    top_k: Optional[int] = None
    top_p: Optional[float] = None
    min_p: float = 0.0  # drop tokens with prob < min_p * max prob
    penalties: bool = False
    repetition_penalty: float = 1.0
    frequency_penalty: float = 0.0
    presence_penalty: float = 0.0
    logprobs: int = 0
    seed: int = 0


@dataclasses.dataclass
class Request:
    uid: int
    prompt: List[int]
    max_new_tokens: int
    generated: List[int] = dataclasses.field(default_factory=list)
    slot: int = -1
    done: bool = False
    # per-request sampling overrides (None → the engine's ServeConfig)
    temperature: Optional[float] = None
    top_k: Optional[int] = None
    top_p: Optional[float] = None
    min_p: Optional[float] = None
    # stop sequences (lists of token ids); on a match the matched tokens are
    # trimmed from ``generated`` and the request finishes with reason "stop"
    stop: Optional[List[List[int]]] = None
    # "length" | "stop" (eos or stop sequence) | "cancelled" | None (running)
    finish_reason: Optional[str] = None


class Engine:
    """Host-side request orchestrator around the prefill and step methods,
    on ``device`` ("cuda" unless the caller asks for the CPU)."""

    def __init__(self, params: Any, model_cfg: Any, cfg: ServeConfig = ServeConfig(),
                 lora_adapters: Optional[Dict[str, Any]] = None,
                 draft_params: Any = None, draft_cfg: Any = None, device="cuda"):
        from ao_tpu_torch.models import resolve_model

        if cfg.kv_quant == "float8_e5m2" and cfg.kv_layout == "paged":
            raise ValueError("kv_quant=\"float8_e5m2\" takes the slot layout only: page pools "
                             "are bf16, int8, float8_e4m3fn or int4")
        if cfg.prefix_cache:
            raise _not_ported("the prefix cache", "engine features")
        if cfg.decode_steps_per_call > 1:
            raise _not_ported("multi-step decode (decode_steps_per_call > 1)", "engine features")
        if cfg.spec_draft > 0 or draft_params is not None:
            raise _not_ported("speculative decoding", "engine features")
        if lora_adapters:
            raise _not_ported("LoRA adapters", "engine features")
        if cfg.penalties:
            raise _not_ported("context penalties", "engine features")
        if cfg.logprobs > 0:
            raise _not_ported("logprob outputs", "engine features")
        if cfg.repetition_penalty != 1.0 or cfg.frequency_penalty != 0.0 \
                or cfg.presence_penalty != 0.0:
            raise ValueError("set ServeConfig(penalties=True) to use "
                             "repetition/frequency/presence penalties")

        self.params = params
        self.model_cfg = model_cfg
        self.model = resolve_model(model_cfg)
        self.cfg = cfg
        self.device = torch.device(device)
        b, t = cfg.max_batch, cfg.max_seq
        self.paged = cfg.kv_layout == "paged"
        if self.paged:
            from ao_tpu_torch.serving.paged import PageAllocator, PagedKVPool

            ps = cfg.page_size
            if t % ps or any(pb % ps for pb in cfg.prefill_buckets):
                raise ValueError("max_seq and prefill buckets must be "
                                 f"multiples of page_size={ps}")
            n_pages = cfg.num_pages or (b * t // ps + 1)
            self.caches = [
                tuple(PagedKVPool.create(n_pages, ps, model_cfg.n_kv_heads, model_cfg.head_dim,
                                         cfg.kv_quant or "bf16", device=self.device)
                      for _ in range(2))
                for _ in range(model_cfg.n_layers)
            ]
            self.allocator = PageAllocator(n_pages)
            self._table_host = np.zeros((b, t // ps), np.int32)
            self.block_table = torch.tensor(self._table_host, device=self.device)
            self._slot_pages: List[List[int]] = [[] for _ in range(b)]
        else:
            self.caches = self._init_caches(b, t)
        # prefill scratch caches, one per length, reused: a prefill writes
        # every row a later read can reach (the bucket's whole window; a
        # chunked prompt's rows below its positions)
        self._scratch: Dict[int, list] = {}

        # small per-slot state lives on the host; one device read per step
        self.positions = np.zeros((b,), np.int32)  # next write index
        self.cur_tok = np.zeros((b,), np.int32)
        self.active = np.zeros((b,), bool)
        # device mirrors of (cur_tok, positions, active) for the slot
        # layout's step; invalidated by _mark_state_dirty() whenever the
        # host-side slot state changes
        self._dev_state = None
        self._slots: List[Optional[Request]] = [None] * b
        self._uid = 0
        self._queue: List[Request] = []
        self._finished: List[Request] = []
        self._gen = torch.Generator(device=self.device).manual_seed(cfg.seed)
        self._step_count = 0
        self._finished_total = 0
        self._tokens_total = 0
        self._prefills = 0
        # per-slot sampling parameters
        self._slot_temp = np.full((b,), cfg.temperature, np.float32)
        self._slot_topk = np.full((b,), cfg.top_k or 0, np.int32)
        self._slot_topp = np.full((b,), cfg.top_p or 1.0, np.float32)
        self._slot_minp = np.full((b,), cfg.min_p, np.float32)

    # -- device work ----------------------------------------------------------

    def _init_caches(self, batch: int, length: int) -> list:
        """Per-layer slot caches: quantized with ``kv_quant`` in the slot
        layout, bf16 otherwise (a paged engine's prefill scratch too)."""
        if self.cfg.kv_quant and not self.paged:
            from ao_tpu_torch.serving.kvcache import init_quant_kv_caches

            return init_quant_kv_caches(self.model_cfg, batch, length, self.cfg.kv_quant,
                                        device=self.device)
        return self.model.init_kv_caches(self.model_cfg, batch, length, device=self.device)

    def _scratch_caches(self, length: int) -> list:
        if length not in self._scratch:
            self._scratch[length] = self._init_caches(1, length)
        return self._scratch[length]

    def _prefill_forward(self, prompt: torch.Tensor, plen: int):
        """The bucketed prefill: prompt (1, plen) padded into a scratch
        cache with the flash-attention route; returns (logits, scratch)."""
        scratch = self._scratch_caches(plen)
        positions = torch.arange(plen, dtype=torch.int32, device=self.device)[None]
        logits, _ = self.model.forward(self.params, prompt, self.model_cfg, positions=positions,
                                       kv_caches=scratch, cache_index=0, use_flash=True)
        return logits, scratch

    def _prefill_impl(self, prompt: torch.Tensor, slot: int, true_len: int, samp, *,
                      plen: int) -> torch.Tensor:
        """prompt (1, plen) padded; writes this slot's KV rows and returns
        the first generated token (a device scalar)."""
        logits, scratch = self._prefill_forward(prompt, plen)
        _insert_tree(self.caches, scratch, slot)
        return self._pick(logits[0, true_len - 1][None], samp)[0]

    def _prefill_paged_impl(self, prompt: torch.Tensor, page_ids: torch.Tensor, true_len: int,
                            samp, *, plen: int) -> torch.Tensor:
        """Prefill into a scratch contiguous cache, then bulk-write its rows
        into this request's pages."""
        logits, scratch = self._prefill_forward(prompt, plen)
        for (kp, vp), (sk, sv) in zip(self.caches, scratch):
            kp.write_prompt(sk[0], page_ids)
            vp.write_prompt(sv[0], page_ids)
        return self._pick(logits[0, true_len - 1][None], samp)[0]

    def _step_impl(self, cur_tok, positions, active, samp):
        """One decode step of every slot; returns (next tokens, new
        positions), both on the device."""
        logits, _ = self.model.forward(self.params, cur_tok[:, None], self.model_cfg,
                                       positions=positions[:, None], kv_caches=self.caches,
                                       cache_index=positions)
        nxt = torch.where(active, self._pick(logits[:, -1], samp), cur_tok)
        cap = self.cfg.max_seq - 1
        new_pos = torch.where(active, torch.clamp(positions + 1, max=cap), positions)
        return nxt, new_pos

    def _step_paged_impl(self, cur_tok, positions, active, block_table, samp):
        logits, _ = self.model.forward(self.params, cur_tok[:, None], self.model_cfg,
                                       positions=positions[:, None], kv_caches=self.caches,
                                       cache_index=(block_table, positions))
        return torch.where(active, self._pick(logits[:, -1], samp), cur_tok)

    def _pick(self, logits, samp):
        """Greedy or sampled next tokens (B,) int32 from logits (B, V) with
        per-row (temps, top_ks, top_ps, min_ps) host arrays. The
        reference's ``_pick`` and ``_pick2``: penalties and logprobs, which
        ``_pick2`` adds, are not ported yet."""
        from ao_tpu_torch.serving.sampling import sample_logits_batched

        return sample_logits_batched(logits, self._gen, *samp)

    def _samp_args(self, slot=None):
        """(temps, top_ks, top_ps, min_ps) host arrays: all slots, or one
        slot's length-1 views for a single-row prefill pick."""
        args = (self._slot_temp, self._slot_topk, self._slot_topp, self._slot_minp)
        if slot is not None:
            args = tuple(a[slot:slot + 1] for a in args)
        return args

    def _prefill_chunk_impl(self, scratch, chunk_toks: torch.Tensor, offset: int,
                            *, chunk: int) -> torch.Tensor:
        """One chunk of a long prefill into a (1, max_seq) scratch cache;
        decode-style masking makes causality hold across chunks. Returns the
        chunk's logits (chunk, V)."""
        positions = offset + torch.arange(chunk, dtype=torch.int32, device=self.device)[None]
        logits, _ = self.model.forward(self.params, chunk_toks, self.model_cfg,
                                       positions=positions, kv_caches=scratch,
                                       cache_index=offset)
        return logits[0]

    def _write_pages_impl(self, scratch, page_ids: torch.Tensor, *, n_rows: int) -> None:
        for (kp, vp), (sk, sv) in zip(self.caches, scratch):
            kp.write_prompt(sk[0, :n_rows], page_ids)
            vp.write_prompt(sv[0, :n_rows], page_ids)

    def _prefill_long(self, req: Request, slot: int, page_ids=None) -> torch.Tensor:
        """Chunked prefill for prompts longer than the largest bucket."""
        chunk = max(self.cfg.prefill_buckets)
        scratch = self._scratch_caches(self.cfg.max_seq)
        n = len(req.prompt)
        padded = req.prompt + [0] * ((-n) % chunk)
        logits = None
        for off in range(0, n, chunk):
            toks = torch.tensor(padded[off:off + chunk], dtype=torch.int32,
                                device=self.device)[None]
            logits = self._prefill_chunk_impl(scratch, toks, off, chunk=chunk)
        tok = self._pick(logits[(n - 1) % chunk][None], self._samp_args(slot))[0]
        if self.paged:
            self._write_pages_impl(scratch, torch.tensor(page_ids, device=self.device),
                                   n_rows=len(page_ids) * self.cfg.page_size)
        else:
            _insert_tree(self.caches, scratch, slot)
        return tok

    # -- host API -------------------------------------------------------------

    def submit(self, prompt: List[int], max_new_tokens: int = 32, lora: Optional[str] = None,
               temperature: Optional[float] = None, top_k: Optional[int] = None,
               top_p: Optional[float] = None, min_p: Optional[float] = None,
               repetition_penalty: Optional[float] = None,
               frequency_penalty: Optional[float] = None,
               presence_penalty: Optional[float] = None, stop: Optional[List] = None,
               logprobs: Optional[int] = None,
               logit_bias: Optional[Dict[int, float]] = None) -> int:
        if logprobs is not None:
            raise _not_ported("logprob outputs", "engine features")
        if logit_bias:
            raise _not_ported("logit bias", "engine features")
        if any(x is not None for x in (repetition_penalty, frequency_penalty, presence_penalty)):
            raise ValueError("this engine was built without context "
                             "penalties; set ServeConfig(penalties=True)")
        if lora is not None:
            raise ValueError(f"unknown adapter {lora!r}; have []")
        stop_seqs = None
        if stop:
            # accept one token-id sequence or a list of them
            if all(isinstance(t, int) for t in stop):
                stop = [stop]
            stop_seqs = []
            for s in stop:
                s = list(s)
                if not s or not all(isinstance(t, int) for t in s):
                    raise ValueError("stop must be token-id sequence(s)")
                stop_seqs.append(s)
        req = Request(uid=self._uid, prompt=list(prompt), max_new_tokens=max_new_tokens,
                      temperature=temperature, top_k=top_k, top_p=top_p, min_p=min_p,
                      stop=stop_seqs)
        self._uid += 1
        self._queue.append(req)
        return req.uid

    def _bucket(self, n: int) -> Optional[int]:
        if n >= self.cfg.max_seq:
            raise ValueError(f"prompt length {n} exceeds max_seq {self.cfg.max_seq}")
        for b in self.cfg.prefill_buckets:
            if n <= b:
                return b
        return None  # longer than every bucket → chunked prefill

    def _claim_pages(self, slot: int, n_pg: int) -> List[int]:
        """Allocate ``n_pg`` pages for the request entering ``slot`` and
        point its block-table row at them."""
        ids = [self.allocator.alloc() for _ in range(n_pg)]
        self._slot_pages[slot] = ids
        self._table_host[slot, :] = 0
        self._table_host[slot, :n_pg] = ids
        self.block_table = torch.tensor(self._table_host, device=self.device)
        return ids

    def _admit(self) -> None:
        for slot in range(self.cfg.max_batch):
            if self._slots[slot] is not None or not self._queue:
                continue
            req = self._queue.pop(0)
            req.slot = slot
            cfg = self.cfg
            self._slot_temp[slot] = cfg.temperature if req.temperature is None else req.temperature
            self._slot_topk[slot] = (cfg.top_k or 0) if req.top_k is None else req.top_k
            self._slot_topp[slot] = (cfg.top_p or 1.0) if req.top_p is None else req.top_p
            self._slot_minp[slot] = cfg.min_p if req.min_p is None else req.min_p
            self._prefills += 1
            n = len(req.prompt)
            plen = self._bucket(n)
            if plen is None:
                # chunked long-prompt prefill
                ids = (self._claim_pages(slot, -(-n // cfg.page_size)) if self.paged else None)
                tok = self._prefill_long(req, slot, page_ids=ids)
            else:
                prompt = torch.tensor(req.prompt + [0] * (plen - n), dtype=torch.int32,
                                      device=self.device)[None]
                if self.paged:
                    ids = self._claim_pages(slot, plen // cfg.page_size)
                    tok = self._prefill_paged_impl(prompt, torch.tensor(ids, device=self.device),
                                                   n, self._samp_args(slot), plen=plen)
                else:
                    tok = self._prefill_impl(prompt, slot, n, self._samp_args(slot), plen=plen)
            tok = int(tok)
            req.generated.append(tok)
            self.cur_tok[slot] = tok
            self.positions[slot] = n
            self.active[slot] = True
            self._mark_state_dirty()
            self._slots[slot] = req
            self._maybe_finish(req)

    def _mark_state_dirty(self) -> None:
        """Invalidate the slot layout's device mirrors (call after any
        host-side change of slot state)."""
        self._dev_state = None

    def _maybe_finish(self, req: Request) -> None:
        g = req.generated
        if g and g[-1] == self.cfg.eos_id:
            self._finish(req, "stop")
            return
        if req.stop:
            for s in req.stop:
                if len(g) >= len(s) and g[-len(s):] == s:
                    # trim the stop sequence from the visible output
                    del g[-len(s):]
                    self._finish(req, "stop")
                    return
        full = int(self.positions[req.slot]) + 1 >= self.cfg.max_seq
        if len(g) >= req.max_new_tokens or full:
            self._finish(req, "length")

    def _finish(self, req: Request, reason: str = "length") -> None:
        req.finish_reason = req.finish_reason or reason
        req.done = True
        self._finished_total += 1
        self._tokens_total += len(req.generated)
        self.active[req.slot] = False
        self._mark_state_dirty()
        self._slots[req.slot] = None
        self._finished.append(req)
        if self.paged:
            self.allocator.release(self._slot_pages[req.slot])
            self._slot_pages[req.slot] = []
            # the idle slot's decode writes go to the null page, never into
            # the pages just released to other requests
            self._table_host[req.slot, :] = 0
            self.block_table = torch.tensor(self._table_host, device=self.device)

    def cancel(self, uid: int) -> bool:
        """Abort a request: drop it from the queue, or free its slot and
        pages if in flight (it lands in the next run()'s results with
        whatever tokens it had). Returns False if the uid is unknown or
        already finished."""
        for i, req in enumerate(self._queue):
            if req.uid == uid:
                self._queue.pop(i)
                req.done = True
                req.finish_reason = "cancelled"
                self._finished.append(req)
                return True
        for req in self._slots:
            if req is not None and req.uid == uid:
                self._finish(req, "cancelled")
                return True
        return False

    def _grow_pages(self, horizon: int) -> None:
        """Allocate pages so every active slot can write ``horizon`` more
        tokens starting at its current position."""
        ps = self.cfg.page_size
        dirty = False
        for slot, req in enumerate(self._slots):
            if req is None:
                continue
            last = min(int(self.positions[slot]) + horizon - 1, self.cfg.max_seq - 1)
            while len(self._slot_pages[slot]) <= last // ps:
                pid = self.allocator.alloc()
                self._table_host[slot, len(self._slot_pages[slot])] = pid
                self._slot_pages[slot].append(pid)
                dirty = True
        if dirty:
            self.block_table = torch.tensor(self._table_host, device=self.device)

    @torch.no_grad()
    def step(self) -> None:
        """Admit queued requests into free slots, then advance every active
        slot by one token (one decode forward)."""
        self._admit()
        self._step_count += 1
        if not self.active.any():
            return
        dev = self.device
        if self.paged:
            self._grow_pages(1)
            nxt = self._step_paged_impl(torch.tensor(self.cur_tok, device=dev),
                                        torch.tensor(self.positions, device=dev),
                                        torch.tensor(self.active, device=dev),
                                        self.block_table, self._samp_args())
        else:
            # device mirrors: cur_tok and positions come back from the step
            # itself, so a step without admissions or finishes copies
            # nothing to the device
            if self._dev_state is None:
                self._dev_state = tuple(torch.tensor(a, device=dev)
                                        for a in (self.cur_tok, self.positions, self.active))
            cur_d, pos_d, act_d = self._dev_state
            nxt, new_pos = self._step_impl(cur_d, pos_d, act_d, self._samp_args())
            self._dev_state = (nxt, new_pos, act_d)
        toks_host = nxt.cpu().numpy()  # (B,); the step's one device read
        for slot, req in enumerate(list(self._slots)):
            if req is None:
                continue
            tok = int(toks_host[slot])
            self.cur_tok[slot] = tok
            self.positions[slot] += 1
            req.generated.append(tok)
            self._maybe_finish(req)

    def stats(self) -> Dict[str, Any]:
        """Serving counters (host-side, no device sync): request and token
        totals, slot occupancy and, for the paged layout, the page pool."""
        d: Dict[str, Any] = {
            "steps": self._step_count,
            "prefills": self._prefills,
            "finished_requests": self._finished_total,
            "generated_tokens": self._tokens_total,
            "active_slots": int(self.active.sum()),
            "queued_requests": len(self._queue),
        }
        if self.paged:
            d.update({
                "pages_total": self.caches[0][0].pages.shape[0] - 1,  # page 0 reserved
                "pages_free": len(self.allocator.free),
                "pages_cached_prefix": 0,
                "prefix_cache_entries": 0,
                "prefix_cache_hits": 0,
            })
        return d

    def run(self, max_steps: int = 10_000) -> List[Request]:
        """Drive until queue and slots drain; returns the requests that
        finished during this call, by uid."""
        for _ in range(max_steps):
            if not self._queue and all(s is None for s in self._slots):
                break
            self.step()
        out = sorted(self._finished, key=lambda r: r.uid)
        self._finished = []
        return out
