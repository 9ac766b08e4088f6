from sagecal_tpu_torch.solvers.sharded import pad_rows_to, sharded_joint_fit  # noqa: F401,E501
