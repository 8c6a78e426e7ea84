"""Prompt datasets for reasoning RL and a checkpointable batch iterator.

The port's own copy of ``PromptExample``, ``PromptDataset``,
``StatefulBatchIterator`` and the reasoning-dataset family
(``ReasoningDataset``, ``WideSeekR1Dataset``, ``Rstar2Dataset``,
``create_rl_dataset``) and the VLM's ``VQAExample`` and ``VQADataset``
from ``rlinf_tpu/data/datasets.py``: the batch order comes from
``random.Random(f"{seed}-{epoch}")``, so both packages hand out the same
batches. ``EpisodeDataset`` comes with the embodied SFT and offline part
of the embodied stack (ROADMAP.md §A.11(d)).
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
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


@dataclasses.dataclass
class VQAExample:
    """One VQA row: image (path or array), question, answer(s)."""

    image: object                 # str path or np.ndarray HWC
    question: str
    answers: List[str]
    meta: Optional[dict] = None


class VQADataset:
    """VQA jsonl: {image|image_path, question, answer|answers} (reference
    rlinf/data/datasets VQA/VLM loaders). ``from_jsonl`` reads a local file;
    ``load_image`` decodes a path row to a float32 HWC array in [0, 1]
    (PIL, imported only then) and passes an array row through as float32;
    the answers list feeds the soft-accuracy reward."""

    def __init__(self, examples: Sequence[VQAExample]):
        self.examples = list(examples)

    @staticmethod
    def from_jsonl(path: str, max_examples: Optional[int] = None) -> "VQADataset":
        out = []
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                row = json.loads(line)
                image = row.get("image", row.get("image_path"))
                question = row.get("question", row.get("prompt"))
                answers = row.get("answers")
                if answers is None:
                    a = row.get("answer", row.get("label"))
                    answers = [str(a)] if a is not None else []
                if image is None or question is None:
                    continue
                out.append(VQAExample(image, str(question),
                                      [str(a) for a in answers], meta=row))
                if max_examples and len(out) >= max_examples:
                    break
        return VQADataset(out)

    @staticmethod
    def load_image(ex: VQAExample):
        import numpy as np

        if isinstance(ex.image, str):
            from PIL import Image

            with Image.open(ex.image) as im:
                return np.asarray(im.convert("RGB"), np.float32) / 255.0
        return np.asarray(ex.image, np.float32)

    def __len__(self) -> int:
        return len(self.examples)

    def __getitem__(self, i: int) -> VQAExample:
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


# ---------------------------------------------------------------------------
# Reference reasoning-dataset conventions. Reference: rlinf/data/datasets/reasoning.py (json/jsonl merge, prompt/answer
# keys, chat templating, length filtering with skip-counting, data_size),
# wideseek_r1.py (answer-dict construction, markdown/language tagging),
# rstar2.py (tool-schema chat templating, no special tokens), and the
# create_rl_dataset dispatch of rlinf/data/datasets/__init__.py:30.
# ---------------------------------------------------------------------------


class ReasoningDataset(PromptDataset):
    """Multi-file json/jsonl reasoning dataset with the reference's loading
    conventions. ``tokenizer`` may expose ``apply_chat_template(messages,
    add_generation_prompt=..., tokenize=False)`` (the HF surface, which the
    port's ``HFTokenizer`` has) — required only when
    ``apply_chat_template=True``."""

    def __init__(
        self,
        data_paths,
        *,
        tokenizer=None,
        prompt_key: str = "prompt",
        answer_key: str = "answer",
        apply_chat_template: bool = False,
        filter_prompt_by_length: bool = False,
        max_prompt_length: int = 1024,
        data_size: Optional[int] = None,
        process_workers: int = 1,
        process_batch_size: int = 256,
    ):
        self.tokenizer = tokenizer
        self.prompt_key = prompt_key
        self.answer_key = answer_key
        self.max_prompt_length = max_prompt_length
        rows = self._load_data(
            [data_paths] if isinstance(data_paths, str) else list(data_paths)
        )
        if data_size is not None and data_size >= 0:
            rows = rows[:data_size]
        if apply_chat_template or filter_prompt_by_length:
            rows = self._post_process(
                rows, apply_chat_template, filter_prompt_by_length,
                process_workers, process_batch_size,
            )
            if not rows:
                raise ValueError(
                    f"No samples within max_prompt_length="
                    f"{max_prompt_length}; check the dataset or raise the "
                    "limit"
                )
        super().__init__([self._to_example(r) for r in rows])

    # -- loading ----------------------------------------------------------
    @staticmethod
    def _load_data(paths) -> list:
        merged = []
        for path in paths:
            ext = os.path.splitext(path)[1]
            with open(path, "r", encoding="utf-8") as f:
                if ext == ".jsonl":
                    merged.extend(
                        json.loads(ln) for ln in f if ln.strip())
                elif ext == ".json":
                    content = json.load(f)
                    merged.extend(
                        content if isinstance(content, list) else [content])
                else:
                    raise ValueError(f"Unsupported extension {ext}: {path}")
        return merged

    def _post_process(self, rows, do_template, do_filter, workers, bs):
        batches = [rows[i:i + bs] for i in range(0, len(rows), bs)]
        out, failed = [], 0
        if workers > 1:
            from concurrent.futures import ThreadPoolExecutor

            with ThreadPoolExecutor(workers) as pool:
                for res, nf in pool.map(
                    lambda b: self._post_process_batch(
                        b, do_template, do_filter), batches
                ):
                    out.extend(res)
                    failed += nf
        else:
            for b in batches:
                res, nf = self._post_process_batch(b, do_template, do_filter)
                out.extend(res)
                failed += nf
        if failed:
            logging.warning(
                "%d samples skipped due to format issues (kept %d/%d)",
                failed, len(out), len(rows))
        return out

    def _post_process_batch(self, batch, do_template, do_filter):
        try:
            if do_template:
                for item in batch:
                    item[self.prompt_key] = self._apply_chat_template(
                        item[self.prompt_key])
            if do_filter:
                batch = [
                    item for item in batch
                    if len(self._encode(item[self.prompt_key]))
                    <= self.max_prompt_length
                ]
            return batch, 0
        except Exception:
            return [], len(batch)

    # -- tokenizer hooks (rstar2 overrides both) --------------------------
    def _apply_chat_template(self, prompt):
        if isinstance(prompt, str):
            prompt = [{"role": "user", "content": prompt}]
        return self.tokenizer.apply_chat_template(
            prompt, add_generation_prompt=True, tokenize=False)

    def _encode(self, text: str):
        return self.tokenizer.encode(text)

    def _to_example(self, row) -> PromptExample:
        prompt = row[self.prompt_key]
        answer = row.get(self.answer_key)
        if isinstance(answer, str):
            answer = [answer]          # reference __getitem__ coercion
        return PromptExample(str(prompt), answer, meta=row)


class WideSeekR1Dataset(ReasoningDataset):
    """WideSeek-R1: the answer becomes a grading DICT carrying markdown
    mode, unique columns, evaluation requirements, and language tag
    (reference wideseek_r1.py:41-110)."""

    def __init__(self, data_paths, *, is_markdown: bool = False,
                 unique_columns_key: str = "unique_columns",
                 enable_zh: bool = False, **kw):
        self.is_markdown = is_markdown
        self.unique_columns_key = unique_columns_key
        self.enable_zh = enable_zh
        super().__init__(data_paths, **kw)

    def _to_example(self, row) -> PromptExample:
        language = "en"
        if self.enable_zh:
            iid = str(row.get("instance_id", ""))
            if "zh" in iid or row.get("language", "en") == "zh":
                language = "zh"
        answer = row.get(self.answer_key)
        d = {
            "answer": answer if isinstance(answer, list) else [answer],
            "is_markdown": self.is_markdown,
            "instance_id": row.get("instance_id", ""),
            "language": language,
        }
        if self.is_markdown:
            d["answer"] = answer
            d["unique_columns"] = row.get(self.unique_columns_key, [])
            ev = row.get("evaluation")
            if isinstance(ev, str):
                try:
                    ev = json.loads(ev)
                except json.JSONDecodeError:
                    ev = None
            if isinstance(ev, dict):
                d["required"] = ev.get("required", [])
        return PromptExample(str(row[self.prompt_key]), d, meta=row)


class Rstar2Dataset(ReasoningDataset):
    """rStar2: chat template carries the python-tool schemas and encoding
    adds no special tokens (reference rstar2.py:55-110)."""

    def __init__(self, data_paths, *, tool_schemas=None, **kw):
        if tool_schemas is None:
            try:
                from rlinf_tpu_torch.agents.rstar2 import get_tool_schemas

                tool_schemas = get_tool_schemas()
            except ImportError:
                tool_schemas = []
        self.tool_schemas = tool_schemas
        super().__init__(data_paths, **kw)

    def _apply_chat_template(self, prompt):
        if isinstance(prompt, str):
            prompt = [{"role": "user", "content": prompt}]
        return self.tokenizer.apply_chat_template(
            prompt, tools=self.tool_schemas, add_generation_prompt=True,
            tokenize=False)

    def _encode(self, text: str):
        enc = getattr(self.tokenizer, "encode", None)
        try:
            return enc(text, add_special_tokens=False)
        except TypeError:
            return enc(text)


DATASET_TYPE_MAP = {
    "reasoning": ReasoningDataset,
    "math": ReasoningDataset,
    "wideseek_r1": WideSeekR1Dataset,
    "rstar2": Rstar2Dataset,
}


def create_rl_dataset(data_cfg, tokenizer):
    """(train_dataset, val_dataset) from a ``DataConfig`` — the reference
    ``create_rl_dataset`` dispatch (rlinf/data/datasets/__init__.py:30)."""
    cls = DATASET_TYPE_MAP.get(data_cfg.type)
    if cls is None:
        raise ValueError(
            f"Unknown data.type {data_cfg.type!r}; have "
            f"{sorted(DATASET_TYPE_MAP)}")
    kw = dict(
        tokenizer=tokenizer,
        prompt_key=data_cfg.prompt_key,
        answer_key=data_cfg.answer_key,
        apply_chat_template=data_cfg.apply_chat_template,
        filter_prompt_by_length=data_cfg.filter_prompt_by_length,
        max_prompt_length=data_cfg.max_prompt_len,
        data_size=data_cfg.data_size,
        process_workers=data_cfg.process_workers,
        process_batch_size=data_cfg.process_batch_size,
    )
    train = (cls(data_cfg.train_data_paths, **kw)
             if data_cfg.train_data_paths else None)
    val = (cls(data_cfg.val_data_paths, **kw)
           if data_cfg.val_data_paths else None)
    return train, val
