"""Set-up seconds to parse the OBJ, compile the scene (BVH, trace
rows, shadow table and visibility boxes) and bake it onto the device in the
warm-up Renderer: the host clock around them."""


def read(run):
    return run["setup"]["scene_s"]
