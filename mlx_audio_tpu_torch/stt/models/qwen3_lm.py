"""Shared decode stepper for the Qwen3-LM-decoder families (Qwen3-ASR, its
forced aligner's LM, MegaASR, VyvoTTS, Fun-ASR-Nano; over an unpadded
prompt through `prompt_decode_fns`, the llama LLM-decoder STT families
and, through `qwen3_decode_fns`, MOSS-Transcribe-Diarize, Higgs Audio v3
and MOSS-Music, whose deepstack features enter at the prefill alone).

Counterpart of mlx_audio_tpu/stt/models/qwen3_lm.py: `prompt_bucket`,
`make_decode_fns` and `run_decode` (:32-134). The JAX package compiles a
prefill and a `lax.scan` of DEC_CHUNK steps; here the pair runs eagerly:

* the prefill runs the prompt, right-padded to its bucket, into f32
  caches of bucket + DEC_CHUNK columns under an additive pad mask, and
  returns the last prompt row's logits; before each chunk the caches grow,
  doubling their decode columns up to bucket + max_new, when the chunk's
  steps would not fit (JAX allocates bucket + max_new at once: 1.9 GB at
  Qwen3-ASR's default dims and max_tokens 8,192);
* a chunk runs up to DEC_CHUNK eager steps with every piece of state on
  the device: the repetition penalty over a rolling history of the last
  `repetition_context_size` drawn tokens (padded with -1), the draw
  (`ops.sampling.make_sampler`, from a `torch.Generator`), the stop on an
  EOS id, the tokens from the stop on masked to -1, the next logits. Each
  step's stop flag is copied to the host without blocking
  (`ops/host_flags.py`); step i starts only once step i - 2's flag is
  read, so a request stops at most STEPS_AFTER_EOS step after the step
  that drew its EOS, and the chunk's tokens come back in one read.

The kept tokens are JAX's: the drawn tokens before the first EOS (which is
not kept), at most `max_tokens`. Departures: draws come from a
`torch.Generator` (only greedy decoding compares with JAX token for
token); the decode runs only the steps `max_tokens` asks for (JAX runs
whole chunks and drops the rest), the last step's forward, whose
logits no kept token needs, is not run, and each step reads only the cache
columns written so far (`moss_tts.qwen3_lm_forward`).
"""

from __future__ import annotations

import time
from typing import Callable, Generator, List, Optional, Tuple

import torch

from ...ops.host_flags import FinishedFlags
from ...ops.sampling import make_sampler

DEC_CHUNK = 32
PROMPT_BUCKETS = (256, 512, 1024, 2048, 4096, 8192)
STEPS_AFTER_EOS = 1


def prompt_bucket(n: int) -> int:
    return next((b for b in PROMPT_BUCKETS if n <= b),
                ((n + 511) // 512) * 512)


class DecodeFns:
    """The (prefill, chunk) pair of `make_decode_fns`."""

    def __init__(self, *, text_config, embed_fn, logits_fn, forward_fn,
                 make_caches, bucket: int, max_new: int, sampler,
                 eos_ids: Tuple[int, ...], use_rep: bool, rep_ctx: int):
        self.cfg = text_config
        self.embed_fn, self.logits_fn = embed_fn, logits_fn
        self.forward_fn, self.make_caches = forward_fn, make_caches
        self.bucket, self.max_new = bucket, max_new
        self.sampler, self.eos_ids = sampler, tuple(eos_ids)
        self.use_rep, self.rep_ctx = use_rep, max(rep_ctx, 1)

    @torch.inference_mode()
    def prefill(self, embeds: torch.Tensor, n: int
                ) -> Tuple[torch.Tensor, object]:
        """embeds (1, bucket, D), the first n rows the prompt -> (f32
        logits (1, V) of row n - 1, caches of bucket + DEC_CHUNK columns,
        or bucket + max_new where that is fewer)."""
        cap = self.bucket + min(self.max_new, DEC_CHUNK)
        dev = embeds.device
        caches = self.make_caches(cap)
        pad = torch.zeros(1, cap, device=dev)
        pad[:, n:] = float("-inf")
        hidden, caches = self.forward_fn(embeds, caches, 0, pad)
        return self.logits_fn(hidden[:, n - 1:n])[:, 0].float(), caches

    def start(self, embeds: torch.Tensor, n: int, max_tokens: int,
              seed: int = 0, history=None) -> dict:
        """The prefill, and the state a chunk advances."""
        if max_tokens > self.max_new:
            raise ValueError(f"max_tokens {max_tokens} past the caches' "
                             f"{self.max_new} decode columns")
        dev = embeds.device
        logits, caches = self.prefill(embeds, n)
        hist = torch.full((1, self.rep_ctx), -1, dtype=torch.long,
                          device=dev)
        if history is not None:
            h = torch.as_tensor(history, dtype=torch.long).reshape(1, -1)
            hist = h[:, -self.rep_ctx:].to(dev)
        done = torch.zeros(1, dtype=torch.bool, device=dev)
        return {"logits": logits, "caches": caches, "history": hist,
                "done": done, "t": n, "step": 0, "forwards": 0,
                "max_tokens": max_tokens,
                "flags": FinishedFlags(max(max_tokens, 1), done),
                "generator": torch.Generator(device=dev).manual_seed(
                    int(seed)),
                "eos": torch.tensor(self.eos_ids or (-2,), device=dev)}

    def _room(self, state: dict, steps: int) -> None:
        """Grow state's caches, doubling their decode columns (at most to
        bucket + max_new), until `steps` more forwards fit."""
        caches = state["caches"]
        cols = caches.k.shape[2]
        need = state["t"] + steps
        if need <= cols:
            return
        grow = max(need, self.bucket + 2 * (cols - self.bucket))
        grown = self.make_caches(min(grow, self.bucket + self.max_new))
        grown.k[:, :, :cols] = caches.k
        grown.v[:, :, :cols] = caches.v
        state["caches"] = grown

    @torch.inference_mode()
    def chunk(self, state: dict, n_steps: int = DEC_CHUNK
              ) -> Tuple[List[int], bool]:
        """Up to n_steps steps from `state` (advanced in place) -> (the
        kept tokens of the chunk, whether the request has stopped)."""
        lag = STEPS_AFTER_EOS + 1
        self._room(state, min(n_steps, state["max_tokens"] - state["step"]))
        toks = []
        stopped = False
        for _ in range(n_steps):
            s = state["step"]
            if s >= state["max_tokens"]:
                stopped = True
                break
            if s >= lag and bool(state["flags"].read(s - lag)):
                stopped = True
                break
            hist = state["history"] if self.use_rep else None
            tok = self.sampler(state["logits"], hist, state["generator"])
            if self.eos_ids:
                state["done"] = state["done"] | torch.isin(tok,
                                                           state["eos"])
            if self.use_rep:
                state["history"] = torch.cat([state["history"][:, 1:],
                                              tok[:, None]], dim=1)
            toks.append(torch.where(state["done"], -1, tok))
            state["flags"].record(s, state["done"])
            state["step"] = s + 1
            if state["step"] < state["max_tokens"]:
                hidden, state["caches"] = self.forward_fn(
                    self.embed_fn(tok[:, None]), state["caches"],
                    state["t"], None)
                state["logits"] = self.logits_fn(hidden)[:, -1].float()
                state["t"] += 1
                state["forwards"] += 1
        if not toks:
            return [], True
        read = torch.cat([torch.stack(toks, dim=1),
                          state["done"][:, None].long()], dim=1)[0].tolist()
        kept = [t for t in read[:-1] if t >= 0]
        return kept, stopped or bool(read[-1]) \
            or state["step"] >= state["max_tokens"]


def make_decode_fns(*, text_config, embed_fn: Callable, logits_fn: Callable,
                    forward_fn: Callable, make_caches: Callable, bucket: int,
                    max_new: int = 2048, temperature: float = 0.0,
                    top_p: float = 1.0, top_k: int = 0, min_p: float = 0.0,
                    min_tokens_to_keep: int = 1,
                    eos_ids: Tuple[int, ...] = (),
                    repetition_penalty: float = 1.0,
                    repetition_context_size: int = 20) -> DecodeFns:
    """The (prefill, chunk) pair for one (bucket, sampling config).

    embed_fn(ids (1, 1)) -> embeds; forward_fn(embeds, caches, offset,
    pad_mask) -> (hidden, caches); logits_fn(hidden) -> logits;
    make_caches(columns) -> caches. With repetition_penalty != 1 the chunk
    carries the rolling history of the last repetition_context_size
    tokens."""
    sampler = make_sampler(temperature=temperature, top_k=top_k,
                           top_p=top_p, min_p=min_p,
                           repetition_penalty=repetition_penalty,
                           min_tokens_to_keep=min_tokens_to_keep)
    return DecodeFns(text_config=text_config, embed_fn=embed_fn,
                     logits_fn=logits_fn, forward_fn=forward_fn,
                     make_caches=make_caches, bucket=bucket,
                     max_new=max_new, sampler=sampler, eos_ids=eos_ids,
                     use_rep=repetition_penalty != 1.0,
                     rep_ctx=repetition_context_size)


def prompt_decode_fns(*, text_config, embed_fn: Callable,
                      forward_fn: Callable, logits_fn: Callable,
                      make_caches: Callable, n: int, max_tokens: int,
                      sampling: tuple, eos_ids: Tuple[int, ...],
                      min_context: int = 0) -> DecodeFns:
    """`make_decode_fns` for an n-row prompt, not padded to a bucket, with
    `sampling` the knobs of `llm_stt.sampling_knobs` and the repetition
    penalty's history at least `min_context` tokens long: the one
    stepper of the llama (`llm_stt.decode_fns`) and Qwen3
    (`qwen3_decode_fns`) LLM-decoder STT families."""
    (temperature, top_k, top_p, min_p, repetition_penalty,
     repetition_context_size, min_tokens_to_keep) = sampling
    return make_decode_fns(
        text_config=text_config, embed_fn=embed_fn, logits_fn=logits_fn,
        forward_fn=forward_fn, make_caches=make_caches, bucket=n,
        max_new=max(int(max_tokens), 1), temperature=temperature,
        top_k=top_k, top_p=top_p, min_p=min_p,
        min_tokens_to_keep=min_tokens_to_keep, eos_ids=tuple(eos_ids),
        repetition_penalty=repetition_penalty,
        repetition_context_size=max(repetition_context_size, min_context))


def qwen3_decode_fns(lm, text_config, logits_fn: Callable, n: int,
                     max_tokens: int, sampling: tuple,
                     eos_ids: Tuple[int, ...], deepstack=None) -> DecodeFns:
    """`prompt_decode_fns` over a `tts.models.moss_tts.Qwen3LM`
    (MOSS-Transcribe-Diarize, Higgs Audio v3, MOSS-Music): f32 caches on
    the LM's device; `deepstack` (a list of (1, n, D) tensors) is added
    after the first layers in the prefill alone."""
    from ...tts.models.moss_tts.moss_tts import qwen3_lm_forward

    def forward(embeds, caches, offset, pad_mask):
        return qwen3_lm_forward(lm, embeds, caches, offset, pad_mask,
                                deepstack=deepstack if offset == 0 else None)

    return prompt_decode_fns(
        text_config=text_config, embed_fn=lm.embed_tokens,
        forward_fn=forward, logits_fn=logits_fn,
        make_caches=lambda cols: lm.make_caches(text_config, 1, cols),
        n=n, max_tokens=max_tokens, sampling=sampling, eos_ids=eos_ids)


def iter_decode(fns: DecodeFns, embeds: torch.Tensor, n: int, *,
                max_tokens: int, seed: int = 0, history=None,
                run: Optional[dict] = None
                ) -> Generator[List[int], None, None]:
    """The prefill, then chunks until EOS or max_tokens: yields each
    chunk's kept tokens. `run` (a dict) gets the prompt's length and
    bucket, the chunks, steps and forwards run, the tokens kept and each
    chunk's wall ms up to its read (the first's with the prefill)."""
    run = {} if run is None else run
    t_last = time.perf_counter()
    state = fns.start(embeds, n, max_tokens, seed, history)
    run.update(prompt_len=n, prompt_bucket=fns.bucket, chunks=0, steps=0,
               forwards=0, tokens=0, chunk_ms=[])
    while True:
        new, stopped = fns.chunk(state)
        now = time.perf_counter()
        run["chunk_ms"].append((now - t_last) * 1e3)
        t_last = now
        run.update(chunks=run["chunks"] + 1, steps=state["step"],
                   forwards=state["forwards"],
                   tokens=run["tokens"] + len(new))
        yield new
        if stopped:
            return


def run_decode(model, fns: DecodeFns, embeds: torch.Tensor, n: int, *,
               max_tokens: int, seed: int = 0, on_token=None,
               history=None) -> List[int]:
    """Drive the (prefill, chunk) pair until EOS or max_tokens -> the kept
    tokens; `on_token` sees each as its chunk is read. The run's numbers
    go to `model.last_run` (see `iter_decode`)."""
    run: dict = {}
    out: List[int] = []
    for new in iter_decode(fns, embeds, n, max_tokens=max_tokens, seed=seed,
                           history=history, run=run):
        out.extend(new)
        if on_token is not None:
            for x in new:
                on_token(x)
    if model is not None:
        model.last_run = run
    return out


__all__ = ["DEC_CHUNK", "PROMPT_BUCKETS", "STEPS_AFTER_EOS", "DecodeFns",
           "prompt_bucket", "make_decode_fns", "prompt_decode_fns",
           "qwen3_decode_fns",
           "iter_decode", "run_decode"]
