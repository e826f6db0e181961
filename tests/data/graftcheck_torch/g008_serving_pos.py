"""G008 serving positive fixture: PartitionSpec axes the (batch, model)
SERVING mesh does not bind — the sharded load-path mistakes the rule must
catch (a training-axis spec against a serving mesh, and a typo'd axis in a
NamedSharding placement)."""

import torch

# The port's serving placement names no axis: its grid is a list of device
# rows, [batch_shards][model_shards] (serving/placement.py), and a stripe
# is a tensor on its own device, so none of these placements can name an
# axis the grid lacks.
from hivemall_tpu_torch.serving.placement import ModelSharded, Replicated


def make_sharded_scores():
    # a (1, 2) grid: one batch row, two model stripes
    return ModelSharded(2, devices=["cpu", "cpu"]).mesh()


def place_striped(table):
    grid = ModelSharded(4, devices=["cpu"] * 4).mesh()
    stripe = table.shape[0] // len(grid[0])
    return [table[i * stripe:(i + 1) * stripe].to(d)
            for i, d in enumerate(grid[0])]


def place_batch_only(x):
    grid = Replicated(2, devices=["cpu"] * 2).mesh()
    return [x.to(row[0]) for row in grid]


def stage(instances):
    return torch.as_tensor(instances, dtype=torch.float32)
