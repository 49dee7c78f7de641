"""pdx_torch.pipelines — end-to-end workloads."""
