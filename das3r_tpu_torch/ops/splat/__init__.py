from das3r_tpu_torch.ops.splat.settings import RasterSettings
from das3r_tpu_torch.ops.splat.rasterize import RasterAux, rasterize
from das3r_tpu_torch.ops.splat.preprocess import Preprocessed, build_cov3d, preprocess
from das3r_tpu_torch.ops.splat.binning import EntryStream, bin_entry_stream
