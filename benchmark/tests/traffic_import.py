"""The traffic kinds, imported by path as the harness imports them."""

from harness import env

serve = env.traffic_kind("serve_poisson")
train = env.traffic_kind("train_step")
caption = env.traffic_kind("batch_caption")
