// swift-tools-version:5.9
// Swift package over the native transcription client — the thin-shim
// analog of the reference's Swift binding (reference:
// language-bindings/swift/Sources/MoonshineVoice), with the C ABI being
// the service-boundary client (runtime/native/moonshine_client.h).
// Build on a host with a Swift toolchain:
//   swift build -Xlinker -L<dir containing libmoonshine_client>
// This environment has no swiftc; the API/ABI consistency is
// test-checked textually against the C header
// (tests/test_native_client.py::test_swift_api_matches_c_header).
import PackageDescription

let package = Package(
    name: "MoonshineTpu",
    products: [
        .library(name: "MoonshineTpu", targets: ["MoonshineTpu"])
    ],
    targets: [
        .systemLibrary(name: "CMoonshineClient", path: "Sources/CMoonshineClient"),
        .target(
            name: "MoonshineTpu",
            dependencies: ["CMoonshineClient"],
            path: "Sources/MoonshineTpu"
        ),
    ]
)
