"""Known-negative G005 cases: donation done right."""
import torch


def train_step(state, blk):
    return state, 0.0


def score(w, x):
    return w @ x


donating_step = torch.cuda.make_graphed_callables(train_step, SAMPLE)
predict = torch.compile(score)  # predict-shaped: inputs reused by design


def rebind_is_fine(state, blocks):
    for blk in blocks:
        state, loss = donating_step(state, blk)
    return state, loss


def fresh_name_never_rereads(state, blk):
    new_state, loss = donating_step(state, blk)
    return new_state, loss
