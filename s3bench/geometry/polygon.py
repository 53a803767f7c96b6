"""``{"type": "polygon", "name", "keep_inside", "coordinates"}``: the
program's ``GeometryCoordinates2D``, a closed 2D polygon given by its
boundary points (a string names an input the generator made)."""


def make(spec: dict, refine: bool, min_refinement_level):
    from sparsespatialsampling_torch import GeometryCoordinates2D
    return GeometryCoordinates2D(spec["name"], spec["keep_inside"],
                                 spec["coordinates"], refine=refine,
                                 min_refinement_level=min_refinement_level)
