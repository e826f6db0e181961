#!/bin/sh
# Settings of the PyTorch port's fleet (bin/hivemall_tpu_torch_{cluster,
# daemon}.sh), read after conf/cluster_env.sh, whose shared settings
# (python, coordinator port, log dir, metrics endpoint) hold for both
# fleets. Remote hosts read this file from their own checkout: ssh carries
# no environment.

# The training program every port worker runs after joining the cluster, as
# launcher arguments, e.g. "/srv/jobs/train_ctr.py --epochs 4" or
# "-m my_team.train". Empty = join, report the world, exit. The JAX fleet's
# HIVEMALL_TPU_APP is never read by the port's daemon.
#HIVEMALL_TPU_TORCH_APP=

# The launcher's --device. Unset = this host's CUDA device (cuda:LOCAL_RANK,
# the world joined over NCCL); a host without one fails `start`. "cpu" joins
# over gloo: the way to put two ranks on one card, which NCCL refuses.
#HIVEMALL_TPU_DEVICE=cpu

# Seconds `start` waits for the worker's "[launch]" line (after the join).
#HIVEMALL_TPU_START_WAIT=120
