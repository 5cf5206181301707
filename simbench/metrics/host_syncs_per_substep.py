"""Device synchronizations the host made per whole-batch substep, in the
unit counted under torch's sync debug mode (its substeps from the world's
``stages`` counter; a fit unit's include its backward's)."""


def read(rec):
    units = [u for u in rec.units if u["syncs"] is not None and u["spec_substeps"] > 0]
    if not units:
        return None
    return sum(u["syncs"] for u in units) / sum(u["spec_substeps"] for u in units)
