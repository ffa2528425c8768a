"""ROS2 message schema registry.

Mirrors the reference's message definitions (crates/apex-io/src/rosbag/
messages.rs, 94+ types): declarative schemas drive the CDR codec in cdr.py
so each type is a few lines. The core SLAM-relevant families are defined
(std_msgs, builtin_interfaces, geometry_msgs, nav_msgs, sensor_msgs,
tf2_msgs, diagnostic_msgs); registering more is one dict entry.

Messages are plain dicts (field name -> value). The port's copy of the JAX
package's registry: the same 99 schemas, so the same bytes.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

from .cdr import CdrReader, CdrWriter, decode, encode

Schema = List[Tuple[str, Any]]

REGISTRY: Dict[str, Schema] = {}


def register(name: str, schema: Schema):
    REGISTRY[name] = schema
    return name


# --- builtin_interfaces -----------------------------------------------------
register("builtin_interfaces/msg/Time", [("sec", "int32"), ("nanosec", "uint32")])
register("builtin_interfaces/msg/Duration", [("sec", "int32"), ("nanosec", "uint32")])

# --- std_msgs ---------------------------------------------------------------
register("std_msgs/msg/Header", [
    ("stamp", "builtin_interfaces/msg/Time"),
    ("frame_id", "string"),
])
register("std_msgs/msg/String", [("data", "string")])
register("std_msgs/msg/Bool", [("data", "bool")])
register("std_msgs/msg/Int32", [("data", "int32")])
register("std_msgs/msg/Int64", [("data", "int64")])
register("std_msgs/msg/Float32", [("data", "float32")])
register("std_msgs/msg/Float64", [("data", "float64")])
register("std_msgs/msg/Float64MultiArray", [
    ("layout", "std_msgs/msg/MultiArrayLayout"),
    ("data", ("sequence", "float64")),
])
register("std_msgs/msg/MultiArrayLayout", [
    ("dim", ("sequence", "std_msgs/msg/MultiArrayDimension")),
    ("data_offset", "uint32"),
])
register("std_msgs/msg/MultiArrayDimension", [
    ("label", "string"), ("size", "uint32"), ("stride", "uint32"),
])
register("std_msgs/msg/ColorRGBA", [
    ("r", "float32"), ("g", "float32"), ("b", "float32"), ("a", "float32"),
])
# ROS2 scalar wrappers ("byte" is an octet, "char" a uint8 in ROS2 IDL;
# Empty carries the DDS dummy member, matching the Python rosbags layout).
register("std_msgs/msg/Byte", [("data", "uint8")])
register("std_msgs/msg/Char", [("data", "uint8")])
register("std_msgs/msg/Empty", [("structure_needs_at_least_one_member", "uint8")])
register("std_msgs/msg/Int8", [("data", "int8")])
register("std_msgs/msg/Int16", [("data", "int16")])
register("std_msgs/msg/UInt8", [("data", "uint8")])
register("std_msgs/msg/UInt16", [("data", "uint16")])
register("std_msgs/msg/UInt32", [("data", "uint32")])
register("std_msgs/msg/UInt64", [("data", "uint64")])

def _multi_array(name: str, elem: str):
    register(f"std_msgs/msg/{name}", [
        ("layout", "std_msgs/msg/MultiArrayLayout"),
        ("data", ("sequence", elem)),
    ])

_multi_array("ByteMultiArray", "uint8")
_multi_array("Float32MultiArray", "float32")
_multi_array("Int8MultiArray", "int8")
_multi_array("Int16MultiArray", "int16")
_multi_array("Int32MultiArray", "int32")
_multi_array("Int64MultiArray", "int64")
_multi_array("UInt8MultiArray", "uint8")
_multi_array("UInt16MultiArray", "uint16")
_multi_array("UInt32MultiArray", "uint32")
_multi_array("UInt64MultiArray", "uint64")

# --- geometry_msgs ----------------------------------------------------------
register("geometry_msgs/msg/Vector3", [("x", "float64"), ("y", "float64"), ("z", "float64")])
register("geometry_msgs/msg/Point", [("x", "float64"), ("y", "float64"), ("z", "float64")])
register("geometry_msgs/msg/Point32", [("x", "float32"), ("y", "float32"), ("z", "float32")])
register("geometry_msgs/msg/Quaternion", [
    ("x", "float64"), ("y", "float64"), ("z", "float64"), ("w", "float64"),
])
register("geometry_msgs/msg/Pose", [
    ("position", "geometry_msgs/msg/Point"),
    ("orientation", "geometry_msgs/msg/Quaternion"),
])
register("geometry_msgs/msg/Pose2D", [
    ("x", "float64"), ("y", "float64"), ("theta", "float64"),
])
register("geometry_msgs/msg/PoseStamped", [
    ("header", "std_msgs/msg/Header"),
    ("pose", "geometry_msgs/msg/Pose"),
])
register("geometry_msgs/msg/PoseArray", [
    ("header", "std_msgs/msg/Header"),
    ("poses", ("sequence", "geometry_msgs/msg/Pose")),
])
register("geometry_msgs/msg/PoseWithCovariance", [
    ("pose", "geometry_msgs/msg/Pose"),
    ("covariance", ("array", "float64", 36)),
])
register("geometry_msgs/msg/PoseWithCovarianceStamped", [
    ("header", "std_msgs/msg/Header"),
    ("pose", "geometry_msgs/msg/PoseWithCovariance"),
])
register("geometry_msgs/msg/Twist", [
    ("linear", "geometry_msgs/msg/Vector3"),
    ("angular", "geometry_msgs/msg/Vector3"),
])
register("geometry_msgs/msg/TwistStamped", [
    ("header", "std_msgs/msg/Header"),
    ("twist", "geometry_msgs/msg/Twist"),
])
register("geometry_msgs/msg/TwistWithCovariance", [
    ("twist", "geometry_msgs/msg/Twist"),
    ("covariance", ("array", "float64", 36)),
])
register("geometry_msgs/msg/Transform", [
    ("translation", "geometry_msgs/msg/Vector3"),
    ("rotation", "geometry_msgs/msg/Quaternion"),
])
register("geometry_msgs/msg/TransformStamped", [
    ("header", "std_msgs/msg/Header"),
    ("child_frame_id", "string"),
    ("transform", "geometry_msgs/msg/Transform"),
])
register("geometry_msgs/msg/PointStamped", [
    ("header", "std_msgs/msg/Header"),
    ("point", "geometry_msgs/msg/Point"),
])
register("geometry_msgs/msg/Vector3Stamped", [
    ("header", "std_msgs/msg/Header"),
    ("vector", "geometry_msgs/msg/Vector3"),
])
register("geometry_msgs/msg/QuaternionStamped", [
    ("header", "std_msgs/msg/Header"),
    ("quaternion", "geometry_msgs/msg/Quaternion"),
])
register("geometry_msgs/msg/Accel", [
    ("linear", "geometry_msgs/msg/Vector3"),
    ("angular", "geometry_msgs/msg/Vector3"),
])
register("geometry_msgs/msg/Wrench", [
    ("force", "geometry_msgs/msg/Vector3"),
    ("torque", "geometry_msgs/msg/Vector3"),
])
register("geometry_msgs/msg/AccelStamped", [
    ("header", "std_msgs/msg/Header"),
    ("accel", "geometry_msgs/msg/Accel"),
])
register("geometry_msgs/msg/AccelWithCovariance", [
    ("accel", "geometry_msgs/msg/Accel"),
    ("covariance", ("array", "float64", 36)),
])
register("geometry_msgs/msg/AccelWithCovarianceStamped", [
    ("header", "std_msgs/msg/Header"),
    ("accel", "geometry_msgs/msg/AccelWithCovariance"),
])
register("geometry_msgs/msg/Inertia", [
    ("m", "float64"),
    ("com", "geometry_msgs/msg/Vector3"),
    ("ixx", "float64"), ("ixy", "float64"), ("ixz", "float64"),
    ("iyy", "float64"), ("iyz", "float64"), ("izz", "float64"),
])
register("geometry_msgs/msg/InertiaStamped", [
    ("header", "std_msgs/msg/Header"),
    ("inertia", "geometry_msgs/msg/Inertia"),
])
register("geometry_msgs/msg/Polygon", [
    ("points", ("sequence", "geometry_msgs/msg/Point32")),
])
register("geometry_msgs/msg/PolygonStamped", [
    ("header", "std_msgs/msg/Header"),
    ("polygon", "geometry_msgs/msg/Polygon"),
])
register("geometry_msgs/msg/TwistWithCovarianceStamped", [
    ("header", "std_msgs/msg/Header"),
    ("twist", "geometry_msgs/msg/TwistWithCovariance"),
])
register("geometry_msgs/msg/WrenchStamped", [
    ("header", "std_msgs/msg/Header"),
    ("wrench", "geometry_msgs/msg/Wrench"),
])

# --- nav_msgs ---------------------------------------------------------------
register("nav_msgs/msg/Odometry", [
    ("header", "std_msgs/msg/Header"),
    ("child_frame_id", "string"),
    ("pose", "geometry_msgs/msg/PoseWithCovariance"),
    ("twist", "geometry_msgs/msg/TwistWithCovariance"),
])
register("nav_msgs/msg/Path", [
    ("header", "std_msgs/msg/Header"),
    ("poses", ("sequence", "geometry_msgs/msg/PoseStamped")),
])
register("nav_msgs/msg/MapMetaData", [
    ("map_load_time", "builtin_interfaces/msg/Time"),
    ("resolution", "float32"),
    ("width", "uint32"),
    ("height", "uint32"),
    ("origin", "geometry_msgs/msg/Pose"),
])
register("nav_msgs/msg/OccupancyGrid", [
    ("header", "std_msgs/msg/Header"),
    ("info", "nav_msgs/msg/MapMetaData"),
    ("data", ("sequence", "int8")),
])
register("nav_msgs/msg/GridCells", [
    ("header", "std_msgs/msg/Header"),
    ("cell_width", "float32"), ("cell_height", "float32"),
    ("cells", ("sequence", "geometry_msgs/msg/Point")),
])

# --- sensor_msgs ------------------------------------------------------------
register("sensor_msgs/msg/Imu", [
    ("header", "std_msgs/msg/Header"),
    ("orientation", "geometry_msgs/msg/Quaternion"),
    ("orientation_covariance", ("array", "float64", 9)),
    ("angular_velocity", "geometry_msgs/msg/Vector3"),
    ("angular_velocity_covariance", ("array", "float64", 9)),
    ("linear_acceleration", "geometry_msgs/msg/Vector3"),
    ("linear_acceleration_covariance", ("array", "float64", 9)),
])
register("sensor_msgs/msg/PointField", [
    ("name", "string"), ("offset", "uint32"), ("datatype", "uint8"), ("count", "uint32"),
])
register("sensor_msgs/msg/PointCloud2", [
    ("header", "std_msgs/msg/Header"),
    ("height", "uint32"),
    ("width", "uint32"),
    ("fields", ("sequence", "sensor_msgs/msg/PointField")),
    ("is_bigendian", "bool"),
    ("point_step", "uint32"),
    ("row_step", "uint32"),
    ("data", ("sequence", "uint8")),
    ("is_dense", "bool"),
])
register("sensor_msgs/msg/LaserScan", [
    ("header", "std_msgs/msg/Header"),
    ("angle_min", "float32"), ("angle_max", "float32"), ("angle_increment", "float32"),
    ("time_increment", "float32"), ("scan_time", "float32"),
    ("range_min", "float32"), ("range_max", "float32"),
    ("ranges", ("sequence", "float32")),
    ("intensities", ("sequence", "float32")),
])
register("sensor_msgs/msg/NavSatStatus", [("status", "int8"), ("service", "uint16")])
register("sensor_msgs/msg/NavSatFix", [
    ("header", "std_msgs/msg/Header"),
    ("status", "sensor_msgs/msg/NavSatStatus"),
    ("latitude", "float64"), ("longitude", "float64"), ("altitude", "float64"),
    ("position_covariance", ("array", "float64", 9)),
    ("position_covariance_type", "uint8"),
])
register("sensor_msgs/msg/CameraInfo", [
    ("header", "std_msgs/msg/Header"),
    ("height", "uint32"), ("width", "uint32"),
    ("distortion_model", "string"),
    ("d", ("sequence", "float64")),
    ("k", ("array", "float64", 9)),
    ("r", ("array", "float64", 9)),
    ("p", ("array", "float64", 12)),
    ("binning_x", "uint32"), ("binning_y", "uint32"),
    ("roi", "sensor_msgs/msg/RegionOfInterest"),
])
register("sensor_msgs/msg/RegionOfInterest", [
    ("x_offset", "uint32"), ("y_offset", "uint32"),
    ("height", "uint32"), ("width", "uint32"), ("do_rectify", "bool"),
])
register("sensor_msgs/msg/Image", [
    ("header", "std_msgs/msg/Header"),
    ("height", "uint32"), ("width", "uint32"),
    ("encoding", "string"),
    ("is_bigendian", "uint8"),
    ("step", "uint32"),
    ("data", ("sequence", "uint8")),
])
register("sensor_msgs/msg/CompressedImage", [
    ("header", "std_msgs/msg/Header"),
    ("format", "string"),
    ("data", ("sequence", "uint8")),
])
register("sensor_msgs/msg/Range", [
    ("header", "std_msgs/msg/Header"),
    ("radiation_type", "uint8"),
    ("field_of_view", "float32"),
    ("min_range", "float32"), ("max_range", "float32"), ("range", "float32"),
])
register("sensor_msgs/msg/MagneticField", [
    ("header", "std_msgs/msg/Header"),
    ("magnetic_field", "geometry_msgs/msg/Vector3"),
    ("magnetic_field_covariance", ("array", "float64", 9)),
])
register("sensor_msgs/msg/FluidPressure", [
    ("header", "std_msgs/msg/Header"),
    ("fluid_pressure", "float64"),
    ("variance", "float64"),
])
register("sensor_msgs/msg/Temperature", [
    ("header", "std_msgs/msg/Header"),
    ("temperature", "float64"),
    ("variance", "float64"),
])
register("sensor_msgs/msg/JointState", [
    ("header", "std_msgs/msg/Header"),
    ("name", ("sequence", "string")),
    ("position", ("sequence", "float64")),
    ("velocity", ("sequence", "float64")),
    ("effort", ("sequence", "float64")),
])
register("sensor_msgs/msg/BatteryState", [
    ("header", "std_msgs/msg/Header"),
    ("voltage", "float32"), ("temperature", "float32"), ("current", "float32"),
    ("charge", "float32"), ("capacity", "float32"), ("design_capacity", "float32"),
    ("percentage", "float32"),
    ("power_supply_status", "uint8"), ("power_supply_health", "uint8"),
    ("power_supply_technology", "uint8"), ("present", "bool"),
    ("cell_voltage", ("sequence", "float32")),
    ("cell_temperature", ("sequence", "float32")),
    ("location", "string"), ("serial_number", "string"),
])

register("sensor_msgs/msg/ChannelFloat32", [
    ("name", "string"),
    ("values", ("sequence", "float32")),
])
register("sensor_msgs/msg/PointCloud", [
    ("header", "std_msgs/msg/Header"),
    ("points", ("sequence", "geometry_msgs/msg/Point32")),
    ("channels", ("sequence", "sensor_msgs/msg/ChannelFloat32")),
])
register("sensor_msgs/msg/Illuminance", [
    ("header", "std_msgs/msg/Header"),
    ("illuminance", "float64"), ("variance", "float64"),
])
register("sensor_msgs/msg/RelativeHumidity", [
    ("header", "std_msgs/msg/Header"),
    ("relative_humidity", "float64"), ("variance", "float64"),
])
register("sensor_msgs/msg/Joy", [
    ("header", "std_msgs/msg/Header"),
    ("axes", ("sequence", "float32")),
    ("buttons", ("sequence", "int32")),
])
register("sensor_msgs/msg/JoyFeedback", [
    ("type", "uint8"), ("id", "uint8"), ("intensity", "float32"),
])
register("sensor_msgs/msg/JoyFeedbackArray", [
    ("array", ("sequence", "sensor_msgs/msg/JoyFeedback")),
])
register("sensor_msgs/msg/LaserEcho", [
    ("echoes", ("sequence", "float32")),
])
register("sensor_msgs/msg/MultiEchoLaserScan", [
    ("header", "std_msgs/msg/Header"),
    ("angle_min", "float32"), ("angle_max", "float32"), ("angle_increment", "float32"),
    ("time_increment", "float32"), ("scan_time", "float32"),
    ("range_min", "float32"), ("range_max", "float32"),
    ("ranges", ("sequence", "sensor_msgs/msg/LaserEcho")),
    ("intensities", ("sequence", "sensor_msgs/msg/LaserEcho")),
])
register("sensor_msgs/msg/MultiDOFJointState", [
    ("header", "std_msgs/msg/Header"),
    ("joint_names", ("sequence", "string")),
    ("transforms", ("sequence", "geometry_msgs/msg/Transform")),
    ("twist", ("sequence", "geometry_msgs/msg/Twist")),
    ("wrench", ("sequence", "geometry_msgs/msg/Wrench")),
])
register("sensor_msgs/msg/TimeReference", [
    ("header", "std_msgs/msg/Header"),
    ("time_ref", "builtin_interfaces/msg/Time"),
    ("source", "string"),
])

# --- stereo_msgs ------------------------------------------------------------
register("stereo_msgs/msg/DisparityImage", [
    ("header", "std_msgs/msg/Header"),
    ("image", "sensor_msgs/msg/Image"),
    ("f", "float32"), ("t", "float32"),
    ("valid_window", "sensor_msgs/msg/RegionOfInterest"),
    ("min_disparity", "float32"), ("max_disparity", "float32"),
    ("delta_d", "float32"),
])

# --- tf2_msgs ---------------------------------------------------------------
register("tf2_msgs/msg/TFMessage", [
    ("transforms", ("sequence", "geometry_msgs/msg/TransformStamped")),
])
register("tf2_msgs/msg/TF2Error", [
    ("error", "uint8"), ("error_string", "string"),
])

# --- diagnostic_msgs --------------------------------------------------------
register("diagnostic_msgs/msg/KeyValue", [("key", "string"), ("value", "string")])
register("diagnostic_msgs/msg/DiagnosticStatus", [
    ("level", "uint8"), ("name", "string"), ("message", "string"),
    ("hardware_id", "string"),
    ("values", ("sequence", "diagnostic_msgs/msg/KeyValue")),
])
register("diagnostic_msgs/msg/DiagnosticArray", [
    ("header", "std_msgs/msg/Header"),
    ("status", ("sequence", "diagnostic_msgs/msg/DiagnosticStatus")),
])


def deserialize(type_name: str, payload: bytes) -> Dict[str, Any]:
    """CDR payload (with encapsulation header) -> message dict."""
    if type_name not in REGISTRY:
        raise KeyError(f"unknown message type {type_name!r} (register a schema)")
    return decode(type_name, REGISTRY, CdrReader(payload))


def serialize(type_name: str, msg: Dict[str, Any]) -> bytes:
    """Message dict -> CDR payload (with encapsulation header). Missing
    fields are zero-filled."""
    if type_name not in REGISTRY:
        raise KeyError(f"unknown message type {type_name!r} (register a schema)")
    w = CdrWriter()
    encode(type_name, REGISTRY, msg, w)
    return w.getvalue()
