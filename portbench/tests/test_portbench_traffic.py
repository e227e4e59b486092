"""The traffic generators: a seed fixes the schedule and the sizes, and
every seed orders the same set of sizes."""

from portbench import spec
from portbench.traffic import open_poisson, train_batches
from portbench.tests.conftest import BIG_SEED


class _Chat:
    """The chat mix as a serving cell at 1.6 requests a second would run
    it."""

    traffic = spec._load("traffic", "chat")
    cell = {"rate_per_s": 1.6}


def _chat():
    return _Chat


def test_open_loop_same_seed_same_schedule():
    c = _chat()
    a = open_poisson.schedule(c.traffic, c.cell, BIG_SEED, 30, 32000)
    b = open_poisson.schedule(c.traffic, c.cell, BIG_SEED, 30, 32000)
    assert a == b
    assert a[0]["at"] < 0 < a[-1]["at"]


def test_open_loop_other_seed_same_work_in_another_order():
    c = _chat()
    a = open_poisson.schedule(c.traffic, c.cell, BIG_SEED, 51, 32000)
    b = open_poisson.schedule(c.traffic, c.cell, BIG_SEED + 1, 51, 32000)
    assert [x["at"] for x in a] != [x["at"] for x in b]
    assert [x["prompt"] for x in a] != [x["prompt"] for x in b]

    def window(plan):
        return [x for x in plan if 0 <= x["at"] < 51]

    wa, wb = window(a), window(b)
    # the same requests' sizes in the window, in another order
    assert len(wa) == len(wb) == round(c.cell["rate_per_s"] * 51)
    assert sorted(len(x["prompt"]) for x in wa) == sorted(
        len(x["prompt"]) for x in wb)
    assert sorted(x["max_new"] for x in wa) == sorted(
        x["max_new"] for x in wb)


def test_open_loop_lengths_within_the_mix():
    c = _chat()
    mix = c.traffic
    for item in open_poisson.schedule(mix, c.cell, 7, 30, 32000):
        assert (mix["prompt_tokens"]["min"] <= len(item["prompt"])
                <= mix["prompt_tokens"]["max"])
        assert (mix["output_tokens"]["min"] <= item["max_new"]
                <= mix["output_tokens"]["max"])
        assert max(item["prompt"]) < 32000


def test_training_corpus_seeded():
    mix = dict(spec.find("mistral7b-train-s4096").traffic, windows=6)
    a = train_batches.corpus(mix, BIG_SEED, 32768)
    b = train_batches.corpus(mix, BIG_SEED, 32768)
    c = train_batches.corpus(mix, BIG_SEED + 1, 32768)
    assert (a == b).all() and not (a == c).all()
    assert len(a) == 6 * (mix["seq_len"] + 1) and a.max() < 32768
