"""Batched serving engine: fixed-slot batching over a shared fixed-capacity
KV cache.

Port of ``src/repro/serve/engine.py``.  ``ServeEngine`` keeps
``max_batch`` request slots.  New requests are left-padded to
``prompt_len`` and prefilled as a batch (prefill attention runs the flash
kernel on the card); decode then advances all active slots one token per
``step()``.  Finished slots (EOS or ``max_new``) are vacated and refilled
from the queue once the whole batch has drained; generated tokens stream
back on completion.  Deterministic given (params, arrival order).

Every step runs under ``torch.inference_mode()``.  The spans
``serve/prefill`` and ``serve/decode`` end once the sampled tokens are on
the host, so on the card they cover the device work of their step.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import Transformer, init_params
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.trace import span

from .steps import (extend_cache, make_decode_step, make_prefill_step,
                    sample_greedy)


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray              # (S_prompt,) int32
    max_new: int = 32
    eos_id: int = -1                # -1 = never
    generated: Optional[List[int]] = None


class ServeEngine:
    def __init__(self, cfg: ModelConfig,
                 params: Optional[Transformer] = None, max_batch: int = 8,
                 prompt_len: int = 32, s_max: int = 128, seed: int = 0,
                 device: DeviceLike = None):
        if cfg.input_kind != "tokens" or cfg.enc_dec:
            raise NotImplementedError(
                f"{cfg.name}: the engine serves token decoders; serve "
                f"embedding-input and encoder-decoder models through "
                f"make_prefill_step, extend_cache and make_decode_step")
        # "cuda" resolved to its index, as the params' tensors report it
        self.device = torch.empty(0, device=resolve_device(device)).device
        self.cfg = cfg
        self.max_batch = max_batch
        self.prompt_len = prompt_len
        self.s_max = s_max
        if params is None:
            params = init_params(cfg, seed, self.device)
        elif params.device != self.device:
            raise ValueError(f"params on {params.device}, engine on "
                             f"{self.device}")
        self.params = params
        self._prefill = make_prefill_step(cfg)
        self._decode = make_decode_step(cfg)
        self.queue: List[Request] = []
        self.done: Dict[int, List[int]] = {}
        self._slots: List[Optional[Request]] = [None] * max_batch
        self._pos = np.zeros(max_batch, dtype=np.int32)      # next write pos
        self._cache = None
        self._last_tok = np.zeros((max_batch, 1), dtype=np.int32)
        self.metrics = MetricsRegistry()

    # ------------------------------------------------------------------
    def submit(self, req: Request):
        req.generated = []
        self.queue.append(req)

    def _admit(self):
        """Fill slots from the queue; batch-prefill the newcomers.

        Admission is *epoch* batching: slots refill only when the whole
        batch has drained, because every slot shares one ``cache_pos``."""
        if any(s is not None for s in self._slots):
            return
        new_idx = [i for i, s in enumerate(self._slots) if s is None]
        if not new_idx or not self.queue:
            return
        admitted = []
        for i in new_idx:
            if not self.queue:
                break
            self._slots[i] = self.queue.pop(0)
            admitted.append(i)

        toks = np.zeros((self.max_batch, self.prompt_len), dtype=np.int32)
        for i in admitted:
            p = self._slots[i].prompt[-self.prompt_len:]
            toks[i, -len(p):] = p                     # left-pad into the slot
        with span("serve/prefill", n_admitted=len(admitted)):
            logits, caches = self._prefill(
                self.params, {"tokens": torch.from_numpy(toks).to(
                    self.device)})
            # the whole batch drained before admission: replace the cache
            self._cache = extend_cache(self.cfg, caches, self.prompt_len,
                                       self.s_max)
            nxt = sample_greedy(logits).cpu().numpy()
        self.metrics.counter("serve_n_prefills").inc()
        for i in admitted:
            self._pos[i] = self.prefill_written = self.prompt_len
            self._last_tok[i] = nxt[i]
            self._slots[i].generated.append(int(nxt[i, 0]))

    # ------------------------------------------------------------------
    @torch.inference_mode()
    def step(self) -> int:
        """Admit + advance every active slot one token.  Returns #active."""
        self._admit()
        active = [i for i, s in enumerate(self._slots) if s is not None]
        if not active:
            return 0
        # all slots share cache_pos; slots are admitted at the same prompt
        # length so positions stay aligned (fixed-slot batching)
        pos = int(self._pos[active[0]])
        with span("serve/decode", n_active=len(active), cache_pos=pos):
            logits, self._cache = self._decode(
                self.params, self._cache,
                {"tokens": torch.from_numpy(self._last_tok).to(self.device),
                 "cache_pos": pos})
            nxt = sample_greedy(logits).cpu().numpy()
        self.metrics.counter("serve_n_decode_steps").inc()
        self.metrics.counter("serve_n_tokens").inc(len(active))
        for i in active:
            req = self._slots[i]
            tok = int(nxt[i, 0])
            req.generated.append(tok)
            self._last_tok[i] = nxt[i]
            self._pos[i] += 1
            hit_eos = tok == req.eos_id
            full = len(req.generated) >= req.max_new or \
                self._pos[i] + 1 >= self.s_max
            if hit_eos or full:
                self.done[req.uid] = req.generated
                self._slots[i] = None
                self.metrics.counter("serve_n_completed").inc()
                self.metrics.histogram("serve_tokens_per_request").observe(
                    len(req.generated))
        return sum(s is not None for s in self._slots)

    def run(self, max_steps: int = 10_000) -> Dict[int, List[int]]:
        steps = 0
        while (self.queue or any(s is not None for s in self._slots)) \
                and steps < max_steps:
            self.step()
            steps += 1
        return self.done

    def stats(self) -> Dict[str, float]:
        """Serving counters through the typed registry (``serve_*`` names
        in the :mod:`repro_torch.obs.metrics` schema)."""
        return self.metrics.as_stats()
