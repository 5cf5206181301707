from .raymarch import PinholeCamera, render_depth_seg, render_color, get_pointcloud
from .recorder import Recorder3D
