from das3r_tpu_torch.data import colmap, ply, readers, rearrange, trajectory
