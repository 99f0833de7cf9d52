"""Multi-device rendering over `torch.distributed`: the tile x sample mesh
(sharded.py), the latitude-slab scene shard (scene_shard.py), and the
process launcher and rank jobs that drive them (ranks.py)."""
