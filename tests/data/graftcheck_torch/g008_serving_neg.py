"""G008 serving negative fixture: the sharded load-path pattern done
right — every PartitionSpec axis bound by the (batch, model) serving mesh
(serving/placement.py convention), dynamic specs and parameter meshes
trusted — zero findings."""

from hivemall_tpu_torch.serving.placement import ModelSharded

# the port's serving grid names no axis: placements index its rows and
# columns, which no axis name can miss


def make_sharded_scores():
    return ModelSharded(2, devices=["cpu", "cpu"]).mesh()


def place_striped(table, placement):
    grid = placement.mesh()  # the placement is a parameter: trusted
    stripe = table.shape[1] // len(grid[0])
    return [table[:, i * stripe:(i + 1) * stripe].to(d)
            for i, d in enumerate(grid[0])]
