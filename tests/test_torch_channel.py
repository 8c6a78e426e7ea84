"""The port's ``parallel.channel.Channel`` against the JAX package's
(``rlinf_tpu/parallel/channel.py``): the same puts and gets on both give
the same items, sizes and errors. Both are in-process queues; no JAX array
is involved.
"""

import queue
import threading

import pytest

from rlinf_tpu.parallel.channel import Channel as JChannel
from rlinf_tpu_torch.parallel.channel import Channel as TChannel

KINDS = {"jax": JChannel, "port": TChannel}


@pytest.fixture(autouse=True)
def _clean_registries():
    for kind in KINDS.values():
        kind.reset_registry()
    yield
    for kind in KINDS.values():
        kind.reset_registry()


def _script(kind):
    """One sequence of calls; every observable result, in order."""
    out = []
    ch = kind.create("rollout_to_actor")
    out.append(kind.connect("rollout_to_actor") is ch)
    out.append((ch.empty(), ch.qsize()))
    for i in range(5):
        ch.put(f"item{i}", weight=float(i + 1))
    ch.put("keyed-a", key="a", weight=3.0)
    ch.put("keyed-b", key="b")
    out.append((ch.qsize(), ch.qsize("a"), ch.qsize("b"), ch.empty("c")))
    out.append(ch.get())                                  # FIFO
    out.append(ch.get_batch(5.0))                         # weights 2 + 3 reach 5
    out.append(ch.get_batch(100.0, timeout=0.01))         # drains what is left
    out.append(ch.get(key="a"))
    out.append(ch.get_batch(1.0, key="b"))
    out.append((ch.empty(), ch.empty("a"), ch.empty("b")))
    with pytest.raises(queue.Empty):
        ch.get(block=False)
    with pytest.raises(queue.Empty):
        ch.get(timeout=0.01)
    with pytest.raises(ValueError, match="already exists"):
        kind.create("rollout_to_actor")
    with pytest.raises(KeyError, match="no channel named"):
        kind.connect("missing")
    return out


def test_channel_matches_jax_on_one_script():
    """FIFO order, keyed queues, weighted batches (stopping once the target
    weight is reached, draining on a timeout), sizes, and the errors of
    ``create``/``connect``/``get``: the port's results equal the JAX
    class's."""
    want = _script(JChannel)
    got = _script(TChannel)
    assert got == want
    assert want[3] == "item0" and want[4] == ["item1", "item2"]


@pytest.mark.parametrize("name", list(KINDS))
def test_bounded_channel_blocks_and_times_out(name):
    """``maxsize`` bounds each key's queue: a put on a full queue raises
    ``queue.Full`` after its timeout, as in the JAX class."""
    kind = KINDS[name]
    ch = kind.create("bounded", maxsize=2)
    ch.put(1)
    ch.put(2)
    with pytest.raises(queue.Full):
        ch.put(3, timeout=0.01)
    ch.put(3, key="other")                     # another key has its own queue
    assert ch.get() == 1 and ch.qsize() == 1 and ch.qsize("other") == 1


def test_get_batch_waits_for_a_producer_thread():
    """``get_batch`` without a timeout blocks for its first item, as the JAX
    class: a producer thread's puts reach a consumer that started first,
    and both classes return the same batch."""
    results = {}
    for name, kind in KINDS.items():
        ch = kind.create(f"threads_{name}")

        def produce():
            for i in range(4):
                ch.put(i, weight=1.0)

        t = threading.Timer(0.05, produce)
        t.start()
        batch = ch.get_batch(4.0)
        t.join()
        while len(batch) < 4:           # the producer may still be mid-way
            batch += ch.get_batch(4.0 - len(batch))
        results[name] = batch
    assert results["port"] == results["jax"] == [0, 1, 2, 3]


def test_reset_registry_forgets_every_channel():
    for kind in KINDS.values():
        kind.create("x")
        kind.reset_registry()
        with pytest.raises(KeyError):
            kind.connect("x")
        kind.create("x")                 # the name is free again
