"""The port's distributed layer (the JAX package's ``repro.distributed``):
sharding rules, annotations, compressed gradients, the pipeline and
failure supervision, on ``torch.distributed`` meshes and DTensors."""
