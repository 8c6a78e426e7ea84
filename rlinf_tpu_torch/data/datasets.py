"""Prompt datasets for reasoning RL and a checkpointable batch iterator.

The port's own copy of ``PromptExample``, ``PromptDataset`` and
``StatefulBatchIterator`` from ``rlinf_tpu/data/datasets.py``: the batch
order comes from ``random.Random(f"{seed}-{epoch}")``, so both packages
hand out the same batches. The VQA, episode and reasoning-dataset
families are not ported yet.
"""

from __future__ import annotations

import dataclasses
import json
import random
from typing import Dict, List, Optional, Sequence


@dataclasses.dataclass
class PromptExample:
    prompt: str
    answer: str
    meta: Optional[dict] = None


class PromptDataset:
    """jsonl with {prompt|question|problem, answer|solution} fields."""

    PROMPT_KEYS = ("prompt", "question", "problem", "query")
    ANSWER_KEYS = ("answer", "solution", "ground_truth", "label")

    def __init__(self, examples: Sequence[PromptExample]):
        self.examples = list(examples)

    @staticmethod
    def from_jsonl(path: str, max_examples: Optional[int] = None) -> "PromptDataset":
        out = []
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                row = json.loads(line)
                prompt = next(
                    (row[k] for k in PromptDataset.PROMPT_KEYS if k in row), None
                )
                answer = next(
                    (row[k] for k in PromptDataset.ANSWER_KEYS if k in row), None
                )
                if prompt is None:
                    continue
                out.append(PromptExample(str(prompt), str(answer), meta=row))
                if max_examples and len(out) >= max_examples:
                    break
        return PromptDataset(out)

    def __len__(self) -> int:
        return len(self.examples)

    def __getitem__(self, i: int) -> PromptExample:
        return self.examples[i]


class StatefulBatchIterator:
    """Infinite shuffled batch iterator with exact-resume state
    (``state_dict``/``load_state_dict``, as torchdata's
    StatefulDataLoader)."""

    def __init__(self, dataset: PromptDataset, batch_size: int, seed: int = 0):
        self.dataset = dataset
        self.batch_size = batch_size
        self.seed = seed
        self.epoch = 0
        self.index = 0
        self._order: List[int] = []
        self._reshuffle()

    def _reshuffle(self):
        rng = random.Random(f"{self.seed}-{self.epoch}")
        self._order = list(range(len(self.dataset)))
        rng.shuffle(self._order)

    def next_batch(self) -> List[PromptExample]:
        out = []
        while len(out) < self.batch_size:
            if self.index >= len(self._order):
                self.epoch += 1
                self.index = 0
                self._reshuffle()
            out.append(self.dataset[self._order[self.index]])
            self.index += 1
        return out

    def state_dict(self) -> Dict:
        return {"epoch": self.epoch, "index": self.index, "seed": self.seed}

    def load_state_dict(self, state: Dict):
        self.seed = state["seed"]
        self.epoch = state["epoch"]
        self.index = state["index"]
        self._reshuffle()
