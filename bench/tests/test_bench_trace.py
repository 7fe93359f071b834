"""Reading a traced slice: markers pair up with the spans, busy time is
the union of device events, and idle gaps carry the host span open at
their start."""

from bench import trace


def test_reduce_events_pairs_markers_and_labels_gaps():
    spans = trace.Spans(torch=None)
    spans.order = ["moe_ffn", "optimizer"]
    # host ns; device ns = host ns + 1000
    spans.host = [("train_step", 100, 900), ("moe_ffn", 200, 400)]
    M = trace.MARKER
    events = [(M, 1050, 1),                       # clock tie at host 50
              ("k1", 1100, 50),                   # 1100-1150
              (M, 1200, 1), ("gemm", 1210, 100),  # inside moe_ffn's markers
              (M, 1320, 1),
              ("k2", 1500, 100),                  # after a gap 1310-1500
              (M, 1600, 1), ("adam", 1610, 40), (M, 1660, 1)]
    sl = trace.reduce_events(events, spans, t_cal=50, t0=100, t1=1000)
    assert sl.window_s == 900e-9
    assert abs(sl.busy_s - 290e-9) < 1e-15
    assert abs(sl.span_s["moe_ffn"] - 100e-9) < 1e-15
    assert abs(sl.span_s["optimizer"] - 40e-9) < 1e-15
    assert sl.span_calls == {"moe_ffn": 1, "optimizer": 1}
    gaps = {round(s * 1e9): label for s, label in sl.gaps}
    assert gaps == {60: "train_step",        # 1150-1210: host at 150
                    190: "moe_ffn",           # 1310-1500: host at 310
                    10: "train_step",        # 1600-1610: host at 600
                    350: "train_step"}       # 1650-2000: host at 650
    b = trace.breakdown(sl)
    assert b["device_ops"][0][0] == "gemm"
    assert [n for n, _ in b["idle_gaps"]] == ["train_step", "moe_ffn"]
