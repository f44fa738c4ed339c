"""The port's drivers: the three training stages of the paper's protocol
(run_fc_con, run_att, run_joint) and the chain from raw images to harvested
results (reproduce_coco), each runnable as
`python -m cooperativeimagecaptioning_tpu_torch.scripts.<name>`."""
