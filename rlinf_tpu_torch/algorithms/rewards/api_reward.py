"""HTTP API reward client: score rollouts via an external judge service.

The port's own copy of ``rlinf_tpu/algorithms/rewards/api_reward.py``:
OpenAI-style chat payloads (optionally with base64 frames) posted to a
judge endpoint, the reply parsed into a scalar reward, requests fanned out
over a thread pool. Host-side code only (standard-library urllib and
threads), with retry and a parse hook.
"""

from __future__ import annotations

import base64
import concurrent.futures
import json
import re
import urllib.error
import urllib.request
from typing import Any, Callable, Dict, List, Optional, Sequence


def default_score_parser(text: str) -> float:
    """Extract the last number in the judge's reply (the common 'Score: 0.8'
    convention); 0.0 if none found."""
    nums = re.findall(r"-?\d+(?:\.\d+)?", text)
    return float(nums[-1]) if nums else 0.0


def frame_to_data_url(frame_bytes: bytes, mime: str = "image/png") -> str:
    """base64 data-URL for image payloads (reference _frame_to_data_url)."""
    return f"data:{mime};base64,{base64.b64encode(frame_bytes).decode()}"


class APIRewardClient:
    """Batched reward scoring against an OpenAI-chat-style HTTP endpoint.

    ``build_payload(sample) -> dict`` maps one rollout sample to the request
    body; ``parse(response_text) -> float`` extracts the scalar reward.
    """

    def __init__(
        self,
        base_url: str,
        *,
        model: str = "judge",
        api_key: Optional[str] = None,
        timeout: float = 30.0,
        max_retries: int = 2,
        max_workers: int = 8,
        parse: Callable[[str], float] = default_score_parser,
    ):
        self.base_url = base_url.rstrip("/")
        self.model = model
        self.api_key = api_key
        self.timeout = timeout
        self.max_retries = max_retries
        self.max_workers = max_workers
        self.parse = parse

    def _post(self, path: str, body: Dict[str, Any]) -> Dict[str, Any]:
        data = json.dumps(body).encode()
        headers = {"Content-Type": "application/json"}
        if self.api_key:
            headers["Authorization"] = f"Bearer {self.api_key}"
        last_err: Optional[Exception] = None
        for _ in range(self.max_retries + 1):
            req = urllib.request.Request(
                self.base_url + path, data=data, headers=headers)
            try:
                with urllib.request.urlopen(req, timeout=self.timeout) as r:
                    return json.loads(r.read().decode())
            except (urllib.error.URLError, TimeoutError, OSError) as e:
                last_err = e
        raise RuntimeError(f"API reward request failed: {last_err}")

    @staticmethod
    def _extract_text(response: Dict[str, Any]) -> str:
        """OpenAI chat completion response → assistant text (reference
        _extract_text)."""
        try:
            return response["choices"][0]["message"]["content"]
        except (KeyError, IndexError, TypeError):
            return ""

    def score_one(self, messages: List[Dict[str, Any]], **kwargs) -> float:
        body = {"model": self.model, "messages": messages, **kwargs}
        resp = self._post("/v1/chat/completions", body)
        return self.parse(self._extract_text(resp))

    def score_batch(
        self, payloads: Sequence[List[Dict[str, Any]]], **kwargs
    ) -> List[float]:
        """Thread-pool fan-out, order-preserving (reference _generate)."""
        if not payloads:
            return []
        workers = min(self.max_workers, len(payloads))
        with concurrent.futures.ThreadPoolExecutor(workers) as ex:
            return list(ex.map(lambda m: self.score_one(m, **kwargs),
                               payloads))
