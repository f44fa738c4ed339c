"""The port's drivers: the three training stages of the paper's protocol
(run_fc_con, run_att, run_joint), the chain from raw images to harvested
results (reproduce_coco), and the paper's experiments over them
(showcase_full_scale, mode_grid with fixed_listener_rank and
mode_grid_report, time_eval_protocol), each runnable as
`python -m cooperativeimagecaptioning_tpu_torch.scripts.<name>`."""
