"""The mesh layer: a corpus row-sharded over logical shards placed on
torch devices (mesh.py), the sharded exact scan (sharded.py) and one
HNSW subgraph per shard (hnsw_sharded.py)."""
