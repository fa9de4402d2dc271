"""Map sharding over `torch.distributed`: the model and the keyframe store
split over the ranks of a process group (the JAX package's "map" mesh
axis), with the frame's math replicated on every rank."""
