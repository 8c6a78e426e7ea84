"""Serve a model behind an OpenAI-compatible endpoint with continuous
batching (server-mode rollout for online/agentic RL).

The port's ``examples/serving/serve_openai.py``: the same engine
(``ContinuousBatchingEngine(cfg, sp, num_slots=32)``, the model's weights
and a bf16 or f32 cache; on the card it decodes through the bf16-cache
decode attention kernel) and the same routes (/v1/completions,
/v1/chat/completions, /health). ``--model`` names a local Hugging Face
checkpoint directory: its config and bf16 weights (``load_hf_pretrained``)
and its tokenizer (``HFTokenizer`` with ``encode`` adding the file's special
tokens, as ``AutoTokenizer.encode`` does), all read by the port itself.
Without it the weights are random from seed 0, the tokenizer is the byte
tokenizer, and ``--preset`` names an ``LLMConfig`` preset; the default is
the JAX example's tiny demo model (head dim 16, f32). The server runs on the
card unless ``--device cpu`` is given, until interrupted.

Usage:
  python -m rlinf_tpu_torch.serve_openai
  python -m rlinf_tpu_torch.serve_openai --device cpu
  python -m rlinf_tpu_torch.serve_openai --preset qwen2_1_5b
  python -m rlinf_tpu_torch.serve_openai --model /path/Qwen2.5-0.5B
then:
  curl localhost:8000/v1/completions -d '{"prompt": "hi", "max_tokens": 16}'
"""

from __future__ import annotations

import argparse
import time
from typing import Optional, Sequence


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description="OpenAI-compatible server on the port")
    ap.add_argument("--model", default=None,
                    help="local HF checkpoint dir (Qwen2/Qwen3/Llama family)")
    ap.add_argument("--preset", default="tiny",
                    help="LLMConfig preset (tiny = the JAX example's demo model, "
                         "vocab 300, 512 positions)")
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--max-new-tokens", type=int, default=256)
    ap.add_argument("--device", default="cuda",
                    help="torch device of the server (cuda, or cpu for the plain "
                         "versions of the kernels)")
    return ap.parse_args(argv)


def model_config(preset: str):
    from rlinf_tpu_torch.models.llm import LLMConfig

    if preset == "tiny":
        return LLMConfig.tiny(vocab_size=300, max_seq_len=512)
    if not isinstance(LLMConfig.__dict__.get(preset), staticmethod):
        raise ValueError(f"unknown LLMConfig preset {preset!r}")
    return getattr(LLMConfig, preset)()


def build_server(args: argparse.Namespace):
    """The started (GenerationServer, OpenAIHTTPServer) pair of ``args``."""
    from rlinf_tpu_torch.data.tokenizers import ByteTokenizer, HFTokenizer
    from rlinf_tpu_torch.models.llm import SamplingParams, init_params
    from rlinf_tpu_torch.models.llm.hf_import import load_hf_pretrained
    from rlinf_tpu_torch.rollout.continuous_engine import ContinuousBatchingEngine
    from rlinf_tpu_torch.rollout.server import GenerationServer, OpenAIHTTPServer
    from rlinf_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    if args.model:
        cfg, params = load_hf_pretrained(args.model, device=device)
        tokenizer = HFTokenizer(args.model, add_special_tokens=True)
    else:
        cfg = model_config(args.preset)
        params = init_params(cfg, 0, device=device)
        tokenizer = ByteTokenizer()
    sp = SamplingParams(max_new_tokens=args.max_new_tokens,
                        eos_token_id=getattr(tokenizer, "eos_token_id", -1) or -1)
    engine = ContinuousBatchingEngine(cfg, sp, num_slots=32, device=device)
    if device.type == "cuda":
        from rlinf_tpu_torch.ops.cuda import build

        build()
    server = GenerationServer(engine, params)
    server.start()
    http = OpenAIHTTPServer(server, tokenizer, port=args.port)
    http.start()
    return server, http


def main(argv: Optional[Sequence[str]] = None) -> None:
    server, http = build_server(parse_args(argv))
    print(f"serving on {http.url} (/v1/completions, /v1/chat/completions, /health)")
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        http.stop()
        server.stop()


if __name__ == "__main__":
    main()
