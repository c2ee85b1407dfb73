"""inc_mesh.s: host time of NeuralMap.extract_mesh_incremental (synced at
both ends) per event, in s."""


def read(ctx):
    spans = ctx.spans.get("inc_mesh")
    return sum(spans) / len(spans) if spans else None
