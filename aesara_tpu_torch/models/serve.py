"""Continuous batching: B decode slots at independent depths, admitted
and retired on the fly, over ONE pair of compiled functions (the
counterpart of ``aesara_tpu/models/serve.py``, built from the same code).

Design (the fixed-shape core every production scheduler builds on —
vLLM-style slot semantics without the paged allocator, which one
device-resident (B, T_max) cache per layer does not need):

- device state lives in SHARED variables: per-layer K/V caches
  ``(B, T_max, Kv, dh)``, per-slot next-write position ``pos (B,)``,
  per-slot current token ``cur (B,)`` and activity mask ``act (B,)``;
- ``_prefill(slot, padded_prompt, plen)``: ONE batched full-sequence
  pass over the padded prompt writes rows ``[0, T_pad)`` of the slot's
  caches.  K/V rows are per-position projections, so pad rows hold
  garbage that is NEVER attended: attention masks ``t <= pos[b]`` and
  ``pos`` only advances as real tokens overwrite those rows;
- ``_decode()``: one ``step_batched_pos`` step for ALL slots (every
  projection batches into one product); inactive slots compute but
  their ``pos`` does not advance and their token is ignored;
- the host-side :class:`ContinuousBatcher` does admission, EOS/length
  retirement, and slot recycling — pure bookkeeping, no device chatter
  beyond reading the (B,) token vector each step.

On the card each of the two functions replays a captured CUDA graph
from its second call with a key: ``_decode`` has one key, ``_prefill``
one for each rung of the prompt's bucket ladder it has seen (a function
keeps ``MAX_KEYS`` of them, ``link/torch/linker.py``).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from aesara_tpu_torch.config import config


class ContinuousBatcher:
    """Serve a :class:`~aesara_tpu_torch.models.decoder.DecoderLM` with
    continuous batching over ``n_slots`` concurrent sequences.

    >>> srv = ContinuousBatcher(model, n_slots=8, t_max=512, t_pad=64)
    >>> rid = srv.submit([1, 2, 3], max_new=100, eos=0)
    >>> while srv.pending():
    ...     for rid, tok in srv.step():
    ...         ...
    >>> srv.result(rid)  # the generated tokens
    """

    def __init__(self, model, n_slots: int, t_max: int, t_pad: int,
                 chunk: int = 1, mode=None):
        from aesara_tpu_torch.compile.function import function
        from aesara_tpu_torch.compile.io import In
        from aesara_tpu_torch.compile.sharedvalue import shared
        from aesara_tpu_torch.scan.basic import scan
        from aesara_tpu_torch.tensor import math as tm
        from aesara_tpu_torch.tensor.basic import cast, switch
        from aesara_tpu_torch.tensor.shape import shape as tshape
        from aesara_tpu_torch.tensor.subtensor import set_subtensor
        from aesara_tpu_torch.tensor.type import TensorType

        if t_pad > t_max:
            raise ValueError(f"t_pad ({t_pad}) exceeds t_max ({t_max})")
        if chunk < 1:
            raise ValueError("chunk must be >= 1")
        self.model = model
        self.n_slots, self.t_max, self.t_pad = n_slots, t_max, t_pad
        self.chunk = int(chunk)
        fX = config.floatX
        device = model.embed.device
        L = len(model.layers)
        Kv, dh = model.layers[0].n_kv_heads, model.layers[0].d_head

        self._caches = []
        for i in range(L):
            for kind in ("k", "v"):
                self._caches.append(shared(
                    np.zeros((n_slots, t_max, Kv, dh), dtype=fX),
                    name=f"{kind}cache{i}", device=device,
                ))
        self._pos = shared(np.zeros(n_slots, dtype="int64"), name="pos", device=device)
        self._cur = shared(np.zeros(n_slots, dtype="int64"), name="cur", device=device)
        self._act = shared(np.zeros(n_slots, dtype="int64"), name="act", device=device)
        # host mirror of the activity mask: the host fully determines
        # it, so retirement never needs a device readback
        self._act_host = np.zeros(n_slots, dtype="int64")

        # ---- decode: `chunk` steps for every slot in ONE program ---------
        # A synchronous device->host readback waits for the device, so
        # the decode runs `chunk` steps per host interaction as a scan
        # and reads the (chunk, B) token block once.  Retirement/admission
        # happen at chunk boundaries; tokens a request emits past its
        # EOS within a chunk are discarded by the host, and the slot's
        # overrun cache rows are masked/overwritten on recycle.
        def kstep(cur, pos, *caches):
            caches = list(caches)
            h = model.embed[cur]
            new_caches = []
            for i, layer in enumerate(model.layers):
                h, kc, vc = layer.step_batched_pos(
                    h, caches[2 * i], caches[2 * i + 1], pos
                )
                new_caches += [kc, vc]
            logits = tm.dot(h, model.embed.T)             # (B, V)
            nxt = cast(tm.argmax(logits, axis=-1), "int64")
            # inactive slots keep their token and position
            new_cur = switch(tm.gt(self._act, 0), nxt, cur)
            new_pos = pos + self._act
            return (new_cur, new_pos, *new_caches)

        if self.chunk == 1:
            res = kstep(self._cur, self._pos, *self._caches)
            toks = res[0].dimshuffle("x", 0)              # (1, B)
            finals = res
        else:
            outs, _ = scan(
                kstep,
                outputs_info=[self._cur, self._pos] + list(self._caches),
                n_steps=self.chunk,
            )
            toks = outs[0]                                # (chunk, B)
            finals = [o[-1] for o in outs]
        ups = {self._cur: finals[0], self._pos: finals[1]}
        for c, fin in zip(self._caches, finals[2:]):
            ups[c] = fin
        self._decode = function([], toks, updates=ups, mode=mode)

        # ---- prefill: fill one slot's caches from a variable-length
        # prompt.  The prompt input has a DYNAMIC length (None dim) and is
        # declared In(seq_bucketed=0): the function zero-pads it up to the
        # pow2 ladder below, so a stream of varying-length prompts runs
        # O(log t_pad) shapes (keys of the function) instead of one per
        # length, and short prompts stop paying t_pad's worth of
        # attention.  Exactness: causal attention never lets rows < plen
        # attend pad rows, and K/V rows beyond plen are overwritten by
        # decode before any read.
        slot = TensorType("int64", ())("slot")
        prompt = TensorType("int64", (None,))("prompt")
        plen = TensorType("int64", ())("plen")
        tcur = tshape(prompt)[0]  # a host value, fixed per key (= the bucket)
        x = model.embed[prompt]                           # (T_b, D)
        hh = x
        pre_ups = {}
        for i, layer in enumerate(model.layers):
            k_rows, v_rows = layer.prefill_kv_rows(hh, tcur)
            kc, vc = self._caches[2 * i], self._caches[2 * i + 1]
            pre_ups[kc] = set_subtensor(kc[slot, :tcur], k_rows)
            pre_ups[vc] = set_subtensor(vc[slot, :tcur], v_rows)
            hh = layer.full(hh)
        # first generated token comes from the LAST REAL row's hidden
        h_last = hh[plen - 1]
        tok0 = cast(tm.argmax(tm.dot(h_last, model.embed.T)), "int64")
        pre_ups[self._cur] = set_subtensor(self._cur[slot], tok0)
        pre_ups[self._pos] = set_subtensor(self._pos[slot], plen)
        pre_ups[self._act] = set_subtensor(self._act[slot], np.int64(1))
        self._prefill = function([slot, In(prompt, seq_bucketed=0), plen],
                                 tok0, updates=pre_ups, mode=mode)
        # pow2 rungs capped at t_pad (t_pad itself is always a rung, so
        # any admitted prompt lands on a rung)
        rungs = []
        r = 1
        while r < t_pad:
            rungs.append(r)
            r *= 2
        rungs.append(t_pad)
        self._prompt_buckets = ",".join(str(r) for r in rungs)

        # ---- host bookkeeping --------------------------------------------
        self._free: List[int] = list(range(n_slots))
        self._rid = 0
        self._slot_of: Dict[int, int] = {}
        self._gen: Dict[int, List[int]] = {}
        self._limits: Dict[int, Tuple[int, Optional[int]]] = {}
        self._done: Dict[int, List[int]] = {}

    # -- public API ----------------------------------------------------------
    def submit(self, prompt_tokens, max_new: int, eos: Optional[int] = None) -> int:
        """Admit a request; returns a request id.  Raises when no slot is
        free (callers backpressure on ``free_slots()``)."""
        prompt_tokens = list(int(t) for t in prompt_tokens)
        if not prompt_tokens:
            raise ValueError("empty prompt")
        if max_new < 1:
            raise ValueError("max_new must be >= 1")
        if len(prompt_tokens) > self.t_pad:
            raise ValueError(
                f"prompt length {len(prompt_tokens)} exceeds t_pad "
                f"({self.t_pad}) — raise t_pad or chunk the prompt"
            )
        if len(prompt_tokens) + max_new > self.t_max:
            raise ValueError("prompt + max_new exceeds t_max")
        if not self._free:
            raise RuntimeError("no free slot (check free_slots() first)")
        slot = self._free.pop()
        self._act_host[slot] = 1
        arr = np.asarray(prompt_tokens, dtype="int64")
        with config.change_flags(shape_buckets=self._prompt_buckets):
            tok0 = int(self._prefill(np.int64(slot), arr,
                                     np.int64(len(prompt_tokens))))
        rid = self._rid
        self._rid += 1
        self._slot_of[rid] = slot
        self._gen[rid] = [tok0]
        self._limits[rid] = (max_new, eos)
        if eos is not None and tok0 == eos:
            self._retire(rid)
        elif max_new <= 1:
            self._retire(rid)
        return rid

    def step(self) -> List[Tuple[int, int]]:
        """One decode CHUNK (``chunk`` device steps, one readback) for
        every active slot; returns the (request_id, token) pairs emitted.
        A request that hits EOS/its length limit mid-chunk stops
        emitting immediately; its slot frees at the chunk boundary."""
        if not self._slot_of:
            return []
        toks = self._decode().cpu().numpy()      # (chunk, B): the one readback
        out = []
        for row in toks:
            for rid in list(self._slot_of):
                slot = self._slot_of[rid]
                tok = int(row[slot])
                self._gen[rid].append(tok)
                out.append((rid, tok))
                max_new, eos = self._limits[rid]
                if (eos is not None and tok == eos) or len(self._gen[rid]) >= max_new:
                    self._retire(rid)
        return out

    def pending(self) -> bool:
        return bool(self._slot_of)

    def free_slots(self) -> int:
        return len(self._free)

    def result(self, rid: int) -> List[int]:
        """Generated tokens of a finished request."""
        return self._done[rid]

    # -- internals -------------------------------------------------------------
    def _retire(self, rid: int) -> None:
        # the host fully determines the activity mask (prefill sets 1,
        # retirement sets 0), so keep a host mirror and only upload: a
        # get_value readback would wait for the device at each retirement
        slot = self._slot_of.pop(rid)
        self._done[rid] = self._gen.pop(rid)
        self._act_host[slot] = 0
        self._act.set_value(self._act_host.copy())
        self._free.append(slot)
