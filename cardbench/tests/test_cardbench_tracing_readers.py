"""The readers of the request path's host steps, on synthetic spans and
counter snapshots: each span reader per request, the request's time no
inner span covers, and the executor cache's hit share."""
import pytest

from cardbench import harness

SPAN_READERS = [
    ("serve.validate_ms", "validate"), ("planner.fingerprint_ms",
                                        "fingerprint"),
    ("planner.digest_ms", "digest"), ("planner.upload_ms", "upload"),
    ("planner.product_ms", "product"), ("planner.copy_ms", "copy"),
    ("planner.unpermute_ms", "unpermute"), ("planner.guard_ms", "guard")]


def obs(**kw):
    base = dict(requests=4, spans=[], counters_before={},
                counters_after={}, batching_before=None,
                batching_after=None, profile=None, least_s=0.0)
    base.update(kw)
    return harness.Observation(**base)


def read(bench, name, o):
    return bench.reader(name).read(o)


def request(t: float) -> list:
    """One request's spans from ``t``, as the program nests them."""
    return [("request", t, t + 1.0), ("validate", t + 0.0, t + 0.05),
            ("fingerprint", t + 0.05, t + 0.1), ("plan", t + 0.1, t + 0.15),
            ("execute", t + 0.2, t + 0.8), ("digest", t + 0.2, t + 0.3),
            ("upload", t + 0.3, t + 0.35), ("kernel", t + 0.4, t + 0.8),
            ("product", t + 0.4, t + 0.5), ("copy", t + 0.5, t + 0.6),
            ("unpermute", t + 0.6, t + 0.75), ("guard", t + 0.8, t + 0.9)]


SPANS = request(0.0) + request(2.0)
WIDTH = {"validate": 0.05, "fingerprint": 0.05, "digest": 0.1,
         "upload": 0.05, "product": 0.1, "copy": 0.1, "unpermute": 0.15,
         "guard": 0.1}


@pytest.mark.parametrize("name,span", SPAN_READERS)
def test_span_reader(bench, name, span):
    assert read(bench, name, obs(spans=SPANS)) == pytest.approx(
        1e3 * 2 * WIDTH[span] / 4)
    others = [sp for sp in SPANS if sp[0] != span]
    assert read(bench, name, obs(spans=others)) is None
    assert read(bench, name, obs(spans=SPANS, requests=0)) is None


def test_unattributed_counts_gaps_and_grouping_self_time(bench):
    # per request: [0.15, 0.2) before execute, [0.35, 0.4) in execute
    # outside its children, [0.75, 0.8) in kernel outside its children,
    # [0.9, 1.0) after the guard
    got = read(bench, "serve.unattributed_ms", obs(spans=SPANS))
    assert got == pytest.approx(1e3 * 2 * 0.25 / 4)
    assert read(bench, "serve.unattributed_ms",
                obs(spans=SPANS, requests=0)) is None
    assert read(bench, "serve.unattributed_ms",
                obs(spans=[sp for sp in SPANS
                           if sp[0] != "request"])) is None


def test_unattributed_counts_overlapping_spans_once(bench):
    spans = [("request", 0.0, 1.0), ("plan", 0.1, 0.5),
             ("probe", 0.2, 0.4), ("pack", 0.3, 0.7),
             # reaches past the request's end: clipped to it
             ("guard", 0.9, 1.2),
             # another request's span, outside this one
             ("plan", 1.5, 1.8)]
    got = read(bench, "serve.unattributed_ms", obs(spans=spans, requests=1))
    # covered [0.1, 0.7) and [0.9, 1.0): 0.7 of the request
    assert got == pytest.approx(1e3 * 0.3)


def test_unattributed_with_nothing_inside_is_the_whole_request(bench):
    spans = [("request", 0.0, 0.5), ("execute", 0.1, 0.4),
             ("kernel", 0.2, 0.3)]
    assert read(bench, "serve.unattributed_ms",
                obs(spans=spans, requests=1)) == pytest.approx(500.0)


@pytest.mark.parametrize("before,after,want", [
    ({"exec_cache_hits": 2, "exec_cache_packs": 1},
     {"exec_cache_hits": 12, "exec_cache_packs": 1}, 100.0),
    ({"exec_cache_packs": 5}, {"exec_cache_packs": 9}, 0.0),
    ({}, {"exec_cache_hits": 3, "exec_cache_packs": 1}, 75.0),
    ({"exec_cache_hits": 4, "exec_cache_packs": 4},
     {"exec_cache_hits": 4, "exec_cache_packs": 4}, None),
    ({}, {}, None)])
def test_exec_hit_pct(bench, before, after, want):
    got = read(bench, "planner.exec_hit_pct",
               obs(counters_before=before, counters_after=after))
    assert got == (None if want is None else pytest.approx(want))
