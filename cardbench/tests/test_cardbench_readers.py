"""Each per-layer reader, and the profile arithmetic, on synthetic spans,
counters and device events."""
import pytest

from cardbench import harness, profiling


def obs(**kw):
    base = dict(requests=10, spans=[], counters_before={},
                counters_after={}, batching_before=None,
                batching_after=None, profile=None, least_s=0.0)
    base.update(kw)
    return harness.Observation(**base)


def read(bench, name, o):
    return bench.reader(name).read(o)


def test_every_listed_metric_has_a_reader(bench):
    for m in bench.spec["per_layer"]:
        assert callable(bench.reader(m["name"]).read)


SPANS = [("request", 0.0, 1.0), ("plan", 0.0, 0.2), ("pack", 0.25, 0.3),
         ("execute", 0.3, 0.9), ("kernel", 0.35, 0.85),
         ("batch_pack", 1.0, 1.1), ("plan", 1.1, 1.2)]


@pytest.mark.parametrize("name,want", [
    ("planner.plan_ms", 1e3 * 0.3 / 10), ("planner.pack_ms", 1e3 * 0.15 / 10),
    ("planner.runner_ms", 1e3 * 0.5 / 10)])
def test_span_readers(bench, name, want):
    assert read(bench, name, obs(spans=SPANS)) == pytest.approx(want)
    assert read(bench, name, obs()) is None
    assert read(bench, name, obs(spans=SPANS, requests=0)) is None


EVENTS = [("gemm", "kernel", 1.0, 1.2), ("Memcpy HtoD (Pageable -> Device)",
                                          "memcpy", 1.1, 1.3),
          ("gather", "kernel", 1.5, 1.6), ("Memset (Device)", "memset",
                                           1.9, 2.0)]


def test_profile_arithmetic():
    p = profiling.Profile(1.0, 2.0, EVENTS)
    assert profiling.busy_s(p) == pytest.approx(0.3 + 0.1 + 0.1)
    assert profiling.kernel_s(p) == pytest.approx(0.3)
    assert profiling.idle_gaps(p) == [pytest.approx((1.3, 1.5)),
                                      pytest.approx((1.6, 1.9))]
    top = profiling.top_ops(p)
    assert top[0][0] == "gemm" and top[0][1] == pytest.approx(0.2)
    assert len(top) == 4


def test_gaps_by_span_takes_the_innermost_open_span():
    p = profiling.Profile(1.0, 2.0, EVENTS)
    spans = [("request", 1.0, 1.7), ("plan", 1.35, 1.45),
             ("kernel", 1.2, 1.25)]
    got = dict((k, v) for k, v in profiling.gaps_by_span(p, spans))
    # gap (1.3, 1.5): midpoint 1.4 inside plan; (1.6, 1.9): 1.75 outside
    assert got["plan"] == pytest.approx(0.2)
    assert got[profiling.OUTSIDE] == pytest.approx(0.3)


def test_kind_of_device_event():
    assert profiling._kind("Memcpy DtoH (Device -> Pageable)") == "memcpy"
    assert profiling._kind("Memset (Device)") == "memset"
    assert profiling._kind("void at::native::index_put_kernel") == "kernel"


def test_device_readers(bench):
    p = profiling.Profile(1.0, 2.0, EVENTS)
    assert read(bench, "device.idle_pct", obs(profile=p)) == \
        pytest.approx(50.0)
    assert read(bench, "product_roofline",
                obs(profile=p, least_s=0.003)) == pytest.approx(1.0)
    assert read(bench, "device.idle_pct", obs()) is None
    assert read(bench, "product_roofline", obs(least_s=1.0)) is None
    empty = profiling.Profile(1.0, 2.0, [])
    assert read(bench, "device.idle_pct", obs(profile=empty)) is None
    assert read(bench, "product_roofline",
                obs(profile=empty, least_s=1.0)) is None


def test_reservoir_is_seeded_and_uniform_in_size():
    def draw(seed, n):
        r = harness.Reservoir(5, seed)
        for i in range(n):
            slot = r.slot()
            if slot is not None:
                r.put(slot, i)
        return r.items
    assert draw(3, 100) == draw(3, 100)
    assert draw(3, 100) != draw(4, 100)
    assert draw(3, 3) == [0, 1, 2]
    assert len(draw(3, 100)) == 5
