"""``{"type": "cube", "name", "keep_inside", "lower", "upper"}``: the
program's ``CubeGeometry``, an axis-aligned rectangle or box."""


def make(spec: dict, refine: bool, min_refinement_level):
    from sparsespatialsampling_torch import CubeGeometry
    return CubeGeometry(spec["name"], spec["keep_inside"], spec["lower"],
                        spec["upper"], refine=refine,
                        min_refinement_level=min_refinement_level)
