"""mesh.extract_s: host time of NeuralMap.extract_mesh (lattice, decode,
marching tetrahedra; synced at both ends) and the post-processing, per job,
in s."""


def read(ctx):
    spans = ctx.spans.get("mesh")
    return sum(spans) / len(spans) if spans else None
