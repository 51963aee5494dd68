"""Decoder-only transformer LM with KV-cache serving (the counterpart of
``aesara_tpu/models/decoder.py``, built from the same code).

``DecoderLM.generate_fn()`` compiles the whole decode loop (embedding, L
causal layers reading and writing per-layer KV caches, the LM head and
greedy argmax) into one function: a ``scan`` whose carry holds the
token, the position and the (T_max, H, dh) K/V caches of each layer,
updated with ``set_subtensor``.  On the card the loop's steps are one
captured CUDA graph, and the Scan lowering writes each new K/V row in
place into the loop's own cache buffer (``link/torch/scan_dispatch.py``),
as XLA updates the donated carry in place: no cache copy per step.

Cut from the JAX package's decoder, each raising ``NotImplementedError``
that names what it waits for: sampling (``temperature > 0`` needs the
port's random streams; ``top_k`` needs ``topk``), speculative decoding
(``cumprod``) and beam search (``argtopk``, ``broadcast_to``).
"""

from __future__ import annotations

import numpy as np

from aesara_tpu_torch.config import config
from aesara_tpu_torch.models.base import Model, glorot, zeros
from aesara_tpu_torch.tensor import math as tm
from aesara_tpu_torch.tensor.basic import alloc, arange, as_tensor_variable, cast, constant, join, switch
from aesara_tpu_torch.tensor.extra_ops import repeat as t_repeat
from aesara_tpu_torch.tensor.shape import shape as tshape
from aesara_tpu_torch.tensor.special import softmax
from aesara_tpu_torch.tensor.subtensor import DynamicIncSubtensor, set_subtensor

__all__ = ["TransformerDecoderLayer", "DecoderLM"]


def _dim(x, i: int):
    """``x.shape[i]`` as the JAX package builds it: a ``Shape`` indexed by
    a ``Subtensor`` (the port's ``x.shape`` gives a static dim as a
    constant), so that the two packages' graphs agree node for node."""
    return tshape(x)[i]


def _layer_norm(x, gain, bias, eps=1e-5):
    mu = tm.mean(x, axis=-1, keepdims=True)
    var = tm.mean(tm.sqr(x - mu), axis=-1, keepdims=True)
    return gain * (x - mu) / tm.sqrt(var + eps) + bias


class TransformerDecoderLayer(Model):
    """Pre-LN causal decoder layer (no cross-attention).

    Two entry points: ``full(x)`` for training/prefill over (T, D), and
    ``step(h, k_cache, v_cache, pos)`` for one cached decode step.

    ``n_kv_heads`` < ``n_heads`` gives grouped-query attention (GQA,
    Ainslie et al. 2023): query head ``h`` attends through KV head
    ``h // (n_heads // n_kv_heads)`` — the KV caches shrink by the
    group factor, the decisive memory knob for long-context serving.
    Default (None) is standard multi-head attention.
    """

    def __init__(self, d_model: int, n_heads: int, d_ff: int, seed: int = 0,
                 n_kv_heads: int | None = None):
        super().__init__()
        assert d_model % n_heads == 0
        rng = np.random.default_rng(seed)
        self.d_model, self.n_heads = d_model, n_heads
        self.d_head = d_model // n_heads
        self.n_kv_heads = n_kv_heads if n_kv_heads is not None else n_heads
        assert n_heads % self.n_kv_heads == 0
        self.q_per_kv = n_heads // self.n_kv_heads
        kv_width = self.n_kv_heads * self.d_head
        self.wq = self._register(glorot(rng, d_model, d_model, "wq"))
        self.wk = self._register(glorot(rng, d_model, kv_width, "wk"))
        self.wv = self._register(glorot(rng, d_model, kv_width, "wv"))
        self.wo = self._register(glorot(rng, d_model, d_model, "wo"))
        self.w1 = self._register(glorot(rng, d_model, d_ff, "w1"))
        self.b1 = self._register(zeros((d_ff,), "b1"))
        self.w2 = self._register(glorot(rng, d_ff, d_model, "w2"))
        self.b2 = self._register(zeros((d_model,), "b2"))
        self.ln1_g = self._register(zeros((d_model,), "ln1_g"))
        self.ln1_b = self._register(zeros((d_model,), "ln1_b"))
        self.ln2_g = self._register(zeros((d_model,), "ln2_g"))
        self.ln2_b = self._register(zeros((d_model,), "ln2_b"))
        for g in (self.ln1_g, self.ln2_g):
            g.set_value(np.ones(d_model, dtype=g.get_value().dtype))

    # -- training / prefill: (T, D) with a causal mask ---------------------
    def full(self, x):
        T = _dim(x, 0)
        z = _layer_norm(x, self.ln1_g, self.ln1_b)
        H, dh, Kv = self.n_heads, self.d_head, self.n_kv_heads
        q = tm.dot(z, self.wq).reshape((T, H, dh)).dimshuffle(1, 0, 2)
        k = tm.dot(z, self.wk).reshape((T, Kv, dh)).dimshuffle(1, 0, 2)
        v = tm.dot(z, self.wv).reshape((T, Kv, dh)).dimshuffle(1, 0, 2)
        if Kv != H:
            # GQA: head h reads KV head h // q_per_kv (head layout
            # h = kv*q_per_kv + g, matching np.repeat along heads)
            k = t_repeat(k, self.q_per_kv, axis=0)
            v = t_repeat(v, self.q_per_kv, axis=0)
        scores = tm.batched_dot(q, k.dimshuffle(0, 2, 1)) / np.sqrt(dh)
        rows = arange(T).dimshuffle("x", 0, "x")
        cols = arange(T).dimshuffle("x", "x", 0)
        neg = constant(np.asarray(-1e9, dtype=config.floatX))
        scores = switch(tm.ge(rows, cols), scores, neg)
        attn = softmax(scores, axis=-1)
        ctx = tm.batched_dot(attn, v).dimshuffle(1, 0, 2).reshape(
            (T, self.d_model)
        )
        h = x + tm.dot(ctx, self.wo)
        z2 = _layer_norm(h, self.ln2_g, self.ln2_b)
        ffn = tm.dot(tm.maximum(tm.dot(z2, self.w1) + self.b1, 0.0),
                     self.w2) + self.b2
        return h + ffn

    # -- cached decode: one token against the cache ------------------------
    def step(self, h, k_cache, v_cache, pos):
        """h (D,); caches (T_max, n_kv_heads, dh); pos int scalar.
        Returns (h_out, new_k_cache, new_v_cache)."""
        dh, Kv, G = self.d_head, self.n_kv_heads, self.q_per_kv
        z = _layer_norm(h, self.ln1_g, self.ln1_b)
        q = tm.dot(z, self.wq).reshape((Kv, G, dh))
        k_new = tm.dot(z, self.wk).reshape((Kv, dh))
        v_new = tm.dot(z, self.wv).reshape((Kv, dh))
        k_cache = set_subtensor(k_cache[pos], k_new)
        v_cache = set_subtensor(v_cache[pos], v_new)
        # scores over the whole static cache, masked beyond pos
        scores = tm.sum(
            k_cache.dimshuffle(0, 1, "x", 2) * q.dimshuffle("x", 0, 1, 2),
            axis=-1,
        ) / np.sqrt(dh)                                   # (T_max, Kv, G)
        t_idx = arange(_dim(k_cache, 0)).dimshuffle(0, "x", "x")
        neg = constant(np.asarray(-1e9, dtype=config.floatX))
        scores = switch(tm.le(t_idx, pos), scores, neg)
        attn = softmax(scores, axis=0)                    # over time
        ctx = tm.sum(
            attn.dimshuffle(0, 1, 2, "x") * v_cache.dimshuffle(0, 1, "x", 2),
            axis=0,
        )                                                  # (Kv, G, dh)
        h = h + tm.dot(ctx.reshape((self.d_model,)), self.wo)
        z2 = _layer_norm(h, self.ln2_g, self.ln2_b)
        ffn = tm.dot(tm.maximum(tm.dot(z2, self.w1) + self.b1, 0.0),
                     self.w2) + self.b2
        return h + ffn, k_cache, v_cache


    # -- prefill helper: the K/V rows a (length, D) prefix contributes ------
    def prefill_kv_rows(self, h, length):
        """K/V cache rows for a (length, D) hidden prefix: per-position
        projections of the LN'd input — EXACTLY what full()/step()
        compute, shared by every prefill path (decode, continuous
        batching) so the cache layout cannot desynchronize."""
        z = _layer_norm(h, self.ln1_g, self.ln1_b)
        Kv, dh = self.n_kv_heads, self.d_head
        return (
            tm.dot(z, self.wk).reshape((length, Kv, dh)),
            tm.dot(z, self.wv).reshape((length, Kv, dh)),
        )

    # -- cached block decode: G tokens at positions pos..pos+G-1 -----------
    def step_block(self, hs, k_cache, v_cache, pos, block: int):
        """hs (G, D) embeddings of G consecutive tokens at positions
        ``pos..pos+G-1``; caches (T_max, n_kv_heads, dh); pos int
        scalar; ``block`` = static G.  Returns (hs_out, k_cache,
        v_cache).  The verify pass of speculative decoding: ONE batched
        batched pass scores all G positions against the cache with a
        per-row causal mask (row g sees cache rows t <= pos+g), writing
        the G new K/V rows at ``pos:pos+G`` (a dynamic-slice window)."""
        dh, Kv, G = self.d_head, self.n_kv_heads, self.q_per_kv
        B = block
        z = _layer_norm(hs, self.ln1_g, self.ln1_b)
        q = tm.dot(z, self.wq).reshape((B, Kv, G, dh))
        k_new = tm.dot(z, self.wk).reshape((B, Kv, dh))
        v_new = tm.dot(z, self.wv).reshape((B, Kv, dh))
        # runtime offset, static window: lax.dynamic_update_slice
        _set_block = DynamicIncSubtensor((B,), set_instead_of_inc=True)
        k_cache = _set_block(k_cache, k_new, pos)
        v_cache = _set_block(v_cache, v_new, pos)
        # scores[t, kv, g, b] = k_cache[t,kv,:] . q[b,kv,g,:]
        scores = tm.sum(
            k_cache.dimshuffle(0, 1, "x", "x", 2)
            * q.dimshuffle("x", 1, 2, 0, 3),
            axis=-1,
        ) / np.sqrt(dh)                               # (T_max, Kv, G, B)
        t_idx = arange(_dim(k_cache, 0)).dimshuffle(0, "x", "x", "x")
        b_idx = arange(B).dimshuffle("x", "x", "x", 0)
        neg = constant(np.asarray(-1e9, dtype=config.floatX))
        scores = switch(tm.le(t_idx, pos + b_idx), scores, neg)
        attn = softmax(scores, axis=0)                # over time
        ctx = tm.sum(
            attn.dimshuffle(0, 1, 2, 3, "x")
            * v_cache.dimshuffle(0, 1, "x", "x", 2),
            axis=0,
        )                                             # (Kv, G, B, dh)
        ctx = ctx.dimshuffle(2, 0, 1, 3).reshape((B, self.d_model))
        h = hs + tm.dot(ctx, self.wo)
        z2 = _layer_norm(h, self.ln2_g, self.ln2_b)
        ffn = tm.dot(tm.maximum(tm.dot(z2, self.w1) + self.b1, 0.0),
                     self.w2) + self.b2
        return h + ffn, k_cache, v_cache

    # -- batched cached decode with PER-STREAM positions --------------------
    def step_batched_pos(self, h, k_cache, v_cache, pos):
        """Like ``step_batched`` but ``pos`` is a (B,) int64 VECTOR: each
        stream decodes at its own position — the continuous-batching
        core, where admitted requests are at different depths.  Row b
        attends to cache rows ``t <= pos[b]`` and writes its new K/V at
        ``[b, pos[b]]``."""
        dh, Kv, G = self.d_head, self.n_kv_heads, self.q_per_kv
        z = _layer_norm(h, self.ln1_g, self.ln1_b)
        B = _dim(h, 0)
        q = tm.dot(z, self.wq).reshape((B, Kv, G, dh))
        k_new = tm.dot(z, self.wk).reshape((B, Kv, dh))
        v_new = tm.dot(z, self.wv).reshape((B, Kv, dh))
        # per-row writes as a fused one-hot SELECT, not a scatter with
        # run-time (b, pos[b]) indices, as the JAX package builds it (a
        # scatter serializes on its TPU): the masked rewrite reads and
        # writes the cache once, one K1 launch
        t_sel = arange(_dim(k_cache, 1)).dimshuffle("x", 0, "x", "x")
        write = tm.eq(t_sel, pos.dimshuffle(0, "x", "x", "x"))
        k_cache = cast(
            switch(write, k_new.dimshuffle(0, "x", 1, 2), k_cache),
            k_cache.type.dtype,
        )
        v_cache = cast(
            switch(write, v_new.dimshuffle(0, "x", 1, 2), v_cache),
            v_cache.type.dtype,
        )
        scores = tm.sum(
            k_cache.dimshuffle(0, 1, 2, "x", 3)
            * q.dimshuffle(0, "x", 1, 2, 3),
            axis=-1,
        ) / np.sqrt(dh)                                   # (B, T, Kv, G)
        neg = constant(np.asarray(-1e9, dtype=config.floatX))
        scores = switch(
            tm.le(t_sel, pos.dimshuffle(0, "x", "x", "x")), scores, neg
        )
        attn = softmax(scores, axis=1)                    # over time
        ctx = tm.sum(
            attn.dimshuffle(0, 1, 2, 3, "x")
            * v_cache.dimshuffle(0, 1, 2, "x", 3),
            axis=1,
        )                                                  # (B, Kv, G, dh)
        h = h + tm.dot(ctx.reshape((B, self.d_model)), self.wo)
        z2 = _layer_norm(h, self.ln2_g, self.ln2_b)
        ffn = tm.dot(tm.maximum(tm.dot(z2, self.w1) + self.b1, 0.0),
                     self.w2) + self.b2
        return h + ffn, k_cache, v_cache

    # -- batched cached decode: B synchronized streams ---------------------
    def step_batched(self, h, k_cache, v_cache, pos):
        """h (B, D); caches (B, T_max, n_kv_heads, dh); pos int scalar.
        Returns (h_out, new_k_cache, new_v_cache).  All B streams decode
        in lockstep (continuous batching's fixed-shape core): the (B,
        d)·(d, d) projections batch into one product instead of B
        matvecs — the throughput lever serving stacks rely on."""
        dh, Kv, G = self.d_head, self.n_kv_heads, self.q_per_kv
        z = _layer_norm(h, self.ln1_g, self.ln1_b)
        B = _dim(h, 0)
        q = tm.dot(z, self.wq).reshape((B, Kv, G, dh))
        k_new = tm.dot(z, self.wk).reshape((B, Kv, dh))
        v_new = tm.dot(z, self.wv).reshape((B, Kv, dh))
        k_cache = set_subtensor(k_cache[:, pos], k_new)
        v_cache = set_subtensor(v_cache[:, pos], v_new)
        scores = tm.sum(
            k_cache.dimshuffle(0, 1, 2, "x", 3)
            * q.dimshuffle(0, "x", 1, 2, 3),
            axis=-1,
        ) / np.sqrt(dh)                                   # (B, T, Kv, G)
        t_idx = arange(_dim(k_cache, 1)).dimshuffle("x", 0, "x", "x")
        neg = constant(np.asarray(-1e9, dtype=config.floatX))
        scores = switch(tm.le(t_idx, pos), scores, neg)
        attn = softmax(scores, axis=1)                    # over time
        ctx = tm.sum(
            attn.dimshuffle(0, 1, 2, 3, "x")
            * v_cache.dimshuffle(0, 1, 2, "x", 3),
            axis=1,
        )                                                  # (B, Kv, G, dh)
        h = h + tm.dot(ctx.reshape((B, self.d_model)), self.wo)
        z2 = _layer_norm(h, self.ln2_g, self.ln2_b)
        ffn = tm.dot(tm.maximum(tm.dot(z2, self.w1) + self.b1, 0.0),
                     self.w2) + self.b2
        return h + ffn, k_cache, v_cache


class DecoderLM(Model):
    """Embedding + L decoder layers + tied LM head."""

    def __init__(self, vocab: int, n_layers: int, d_model: int,
                 n_heads: int, d_ff: int, seed: int = 0,
                 n_kv_heads: int | None = None):
        super().__init__()
        rng = np.random.default_rng(seed)
        self.vocab, self.d_model = vocab, d_model
        self.embed = self._register(glorot(rng, vocab, d_model, "embed"))
        self.layers = [
            TransformerDecoderLayer(d_model, n_heads, d_ff, seed=seed + 1 + i,
                                    n_kv_heads=n_kv_heads)
            for i in range(n_layers)
        ]
        for layer in self.layers:
            self._register(*layer.params)

    # -- training loss: next-token xent over a (T,) int sequence -----------
    def loss(self, tokens):
        x = self.embed[tokens[:-1]]                   # (T-1, D)
        h = x
        for layer in self.layers:
            h = layer.full(h)
        logits = tm.dot(h, self.embed.T)              # tied head
        logp = logits - tm.logsumexp(logits, axis=-1, keepdims=True)
        idx = arange(_dim(logp, 0))
        return -tm.mean(logp[idx, tokens[1:]])

    # -- serving: greedy/temperature generation as ONE program -------------
    def generate_graph(self, first_token, n_steps: int, t_max: int,
                      temperature: float = 0.0, seed: int = 0,
                      top_k: int = 0):
        """Symbolic greedy generation of ``n_steps`` tokens from
        ``first_token`` (int scalar variable).  Returns the generated
        int64 vector (length n_steps).  ``temperature`` > 0 and ``top_k``
        raise ``NotImplementedError`` (module docstring); ``seed`` is the
        JAX package's argument of the sampler."""
        from aesara_tpu_torch.scan.basic import scan

        if n_steps > t_max:
            raise ValueError(
                f"generate: n_steps ({n_steps}) exceeds the cache bound "
                f"t_max ({t_max}) — a write past the cache would be an "
                f"out-of-range index on the device"
            )
        _refuse_sampling(temperature, top_k)
        L = len(self.layers)
        Kv, dh = self.layers[0].n_kv_heads, self.layers[0].d_head
        fX = config.floatX

        caches = []
        for i in range(L):
            for kind in ("k", "v"):
                caches.append(
                    alloc(constant(np.asarray(0, dtype=fX)), t_max, Kv, dh)
                )

        def step_fn(tok, pos, *cache_args):
            caches = list(cache_args)
            h = self.embed[tok]
            new_caches = []
            for i, layer in enumerate(self.layers):
                h, kc, vc = layer.step(h, caches[2 * i], caches[2 * i + 1],
                                       pos)
                new_caches += [kc, vc]
            logits = tm.dot(h, self.embed.T)
            nxt = cast(tm.argmax(logits), "int64")
            return (nxt, pos + np.int64(1), *new_caches)

        outs, _ = scan(
            fn=step_fn,
            outputs_info=[cast(as_tensor_variable(first_token), "int64"),
                          constant(np.int64(0))] + caches,
            n_steps=n_steps,
        )
        tokens = outs[0] if isinstance(outs, (list, tuple)) else outs
        return tokens

    def generate_fn(self, n_steps: int, t_max: int, temperature: float = 0.0,
                    top_k: int = 0, mode=None):
        """Compile ``first_token -> generated int64 vector``."""
        from aesara_tpu_torch.compile.function import function
        from aesara_tpu_torch.tensor.type import lscalar

        tok0 = lscalar("tok0")
        toks = self.generate_graph(tok0, n_steps, t_max, temperature,
                                   top_k=top_k)
        return function([tok0], toks, mode=mode)

    # -- prompt serving: prefill the caches, then decode -------------------
    def prefill_graph(self, prompt, prompt_len: int, t_max: int):
        """Run the batched full-sequence forward over ``prompt`` (int
        vector, static length ``prompt_len``) while FILLING the KV
        caches — one batched pass instead of ``prompt_len`` decode
        steps (the prefill/decode split every serving stack makes).
        Returns (last_hidden, caches): caches are (t_max, H, dh) per
        layer with rows [0, prompt_len) populated."""
        if prompt_len > t_max:
            raise ValueError(
                f"prefill: prompt_len ({prompt_len}) exceeds t_max ({t_max})"
            )
        Kv, dh = self.layers[0].n_kv_heads, self.layers[0].d_head
        fX = config.floatX
        x = self.embed[prompt]                       # (P, D)
        caches = []
        h = x
        for layer in self.layers:
            k_rows, v_rows = layer.prefill_kv_rows(h, prompt_len)
            kc = alloc(constant(np.asarray(0, dtype=fX)), t_max, Kv, dh)
            vc = alloc(constant(np.asarray(0, dtype=fX)), t_max, Kv, dh)
            caches.append(set_subtensor(kc[:prompt_len], k_rows))
            caches.append(set_subtensor(vc[:prompt_len], v_rows))
            h = layer.full(h)
        return h[-1], caches

    def generate_from_prompt_fn(self, prompt_len: int, n_new: int,
                                t_max: int, mode=None):
        """Compile ``prompt (int64 vector, len prompt_len) -> n_new
        generated tokens``: ONE program containing the batched prefill
        AND the decode scan."""
        from aesara_tpu_torch.compile.function import function
        from aesara_tpu_torch.scan.basic import scan
        from aesara_tpu_torch.tensor.type import TensorType

        if prompt_len + n_new > t_max:
            raise ValueError(
                f"prompt_len + n_new ({prompt_len + n_new}) exceeds "
                f"t_max ({t_max})"
            )
        prompt = TensorType("int64", (prompt_len,))("prompt")
        h_last, caches = self.prefill_graph(prompt, prompt_len, t_max)
        logits0 = tm.dot(h_last, self.embed.T)
        tok0 = cast(tm.argmax(logits0), "int64")

        def step_fn(tok, pos, *cache_args):
            caches = list(cache_args)
            h = self.embed[tok]
            new_caches = []
            for i, layer in enumerate(self.layers):
                h, kc, vc = layer.step(h, caches[2 * i], caches[2 * i + 1],
                                       pos)
                new_caches += [kc, vc]
            logits = tm.dot(h, self.embed.T)
            nxt = cast(tm.argmax(logits), "int64")
            return (nxt, pos + np.int64(1), *new_caches)

        if n_new == 1:
            return function([prompt], tok0.dimshuffle("x"), mode=mode)
        outs, _ = scan(
            fn=step_fn,
            outputs_info=[tok0, constant(np.int64(prompt_len))] + caches,
            n_steps=n_new - 1,
        )
        cont = outs[0] if isinstance(outs, (list, tuple)) else outs
        # output = tok0 (from the prefill logits) + the n_new-1 decoded
        # continuations
        toks = join(0, tok0.dimshuffle("x"), cont)
        return function([prompt], toks, mode=mode)

    # -- cut: speculative decoding and beam search ---------------------------
    def speculative_generate_fn(self, draft: "DecoderLM", prompt_len: int, n_new: int, t_max: int,
                                n_spec: int = 4, mode=None):
        raise NotImplementedError("speculative decoding needs cumprod (ROADMAP Queue 1 item 12), "
                                  "which the port does not have yet")

    def beam_search_fn(self, prompt_len: int, n_new: int, t_max: int, beam: int = 4, mode=None):
        raise NotImplementedError("beam search needs argtopk and broadcast_to (ROADMAP Queue 1 item 12), "
                                  "which the port does not have yet")

    # -- batched serving ---------------------------------------------------
    def generate_batched_graph(self, first_tokens, batch: int, n_steps: int,
                               t_max: int):
        """Greedy decode of B synchronized streams: ``first_tokens``
        (int vector, length B) → (n_steps, B) int64 matrix."""
        from aesara_tpu_torch.scan.basic import scan

        if n_steps > t_max:
            raise ValueError(
                f"generate: n_steps ({n_steps}) exceeds the cache bound "
                f"t_max ({t_max}) — a write past the cache would be an "
                f"out-of-range index on the device"
            )
        L = len(self.layers)
        Kv, dh = self.layers[0].n_kv_heads, self.layers[0].d_head
        fX = config.floatX

        caches = []
        for _ in range(2 * L):
            caches.append(
                alloc(constant(np.asarray(0, dtype=fX)), batch, t_max, Kv, dh)
            )

        def step_fn(toks, pos, *cache_args):
            caches = list(cache_args)
            h = self.embed[toks]                       # (B, D)
            new_caches = []
            for i, layer in enumerate(self.layers):
                h, kc, vc = layer.step_batched(
                    h, caches[2 * i], caches[2 * i + 1], pos
                )
                new_caches += [kc, vc]
            logits = tm.dot(h, self.embed.T)           # (B, vocab)
            nxt = cast(tm.argmax(logits, axis=-1), "int64")
            return (nxt, pos + np.int64(1), *new_caches)

        outs, _ = scan(
            fn=step_fn,
            outputs_info=[cast(as_tensor_variable(first_tokens), "int64"),
                          constant(np.int64(0))] + caches,
            n_steps=n_steps,
        )
        return outs[0] if isinstance(outs, (list, tuple)) else outs

    def generate_batched_fn(self, batch: int, n_steps: int, t_max: int,
                            mode=None):
        from aesara_tpu_torch.compile.function import function
        from aesara_tpu_torch.tensor.type import lvector

        toks0 = lvector("toks0")
        toks = self.generate_batched_graph(toks0, batch, n_steps, t_max)
        return function([toks0], toks, mode=mode)


def _refuse_sampling(temperature: float, top_k: int) -> None:
    """Greedy decoding only: sampling waits for the port's random streams
    (ROADMAP Queue 1 item 9), top-k truncation for ``topk`` (item 12)."""
    if temperature > 0.0:
        raise NotImplementedError("temperature > 0 samples with RandomStream (ROADMAP Queue 1 item 9), "
                                  "which the port does not have yet; use temperature=0 (greedy)")
    if top_k:
        raise NotImplementedError("top_k needs topk (ROADMAP Queue 1 item 12), which the port does not have yet")
