"""Known-positive G005 donation-misuse cases."""
import torch


def train_step(state, blk):
    return state, 0.0


undonated = torch.compile(train_step)

donating_step = torch.cuda.make_graphed_callables(train_step, SAMPLE)


def read_after_donate(state, blk):
    new_state, loss = donating_step(state, blk)
    return donating_step(new_state, blk), loss  # EXPECT: G005
