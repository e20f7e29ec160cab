"""kf_fleet_self_ms (host clock, program spans): median over the traced
span's keyframing stream-frames of `fleet.stream`'s self time, its
duration less its children's: the fleet's own per-stream code in
`FleetVio._row_step` (host scalars, the policy, the stream's views, the
copies and writes of the row's state)."""

import program_trace


def read(run):
    spans = program_trace.program_spans(run)
    if not spans:
        return None
    own = program_trace.self_ns(spans)
    return program_trace.per_keyframe(
        run, lambda f: sum(own[s.index] for s in f if s.name == "fleet.stream") * 1e-6)
