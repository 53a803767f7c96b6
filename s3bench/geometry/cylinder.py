"""``{"type": "cylinder", "name", "keep_inside", "position", "radius"}``:
the program's ``CylinderGeometry3D``, a cylinder between the centres of
its two end discs (``position``)."""


def make(spec: dict, refine: bool, min_refinement_level):
    from sparsespatialsampling_torch import CylinderGeometry3D
    return CylinderGeometry3D(spec["name"], spec["keep_inside"],
                              spec["position"], spec["radius"],
                              refine=refine,
                              min_refinement_level=min_refinement_level)
