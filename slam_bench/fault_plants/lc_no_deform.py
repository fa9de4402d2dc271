"""A loop closure that leaves the map as it was: the closure is accepted,
the pose and the keyframe poses are corrected, but the deformation graph
is not applied to the model (`deformation.apply_to_model` hands its input
back), so the map keeps the drift the closure was meant to take out."""

NEEDS = ["enable_loop_closure"]


def plant(pipeline, ops):
    from supersurfel_fusion_tpu_torch.ops import deformation

    def apply_to_model(model, *args, **kw):
        return model
    return deformation, "apply_to_model", apply_to_model
