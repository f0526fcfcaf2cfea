"""Example configurations this package can run.

The YAML files themselves are shared with the JAX package and read in place
(``utils.io_utils.get_example_path``); this list names the ones whose
environment is available here.
"""

examples = [
    "unitree_go2_trot",
    "unitree_go2_seq_jump",
    "unitree_go2_crate_climb",
    "unitree_h1_jog",
    "unitree_h1_loco",
    "unitree_h1_push_crate",
    "allegro_reorient",
]

# configurations of the asynchronous deploy path (deploy/planner_proc.py)
deploy_examples = [
    "unitree_go2_trot_deploy",
    "unitree_go2_seq_jump_deploy",
    "unitree_h1_loco_deploy",
]
