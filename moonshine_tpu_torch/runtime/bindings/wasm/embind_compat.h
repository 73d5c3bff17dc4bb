/* Minimal Embind declarations for compiling the WASM shim in an
 * environment without the Emscripten SDK.
 *
 * Purpose: a COMPILE-SURFACE stand-in, the WASM analog of
 * jni_compat.h.  It declares the emscripten::val / class_ / function
 * subset moonshine_embind.cpp uses with compatible signatures, so the
 * thin-wrapper claim over moonshine_client.h is checked by an actual
 * g++ compile + link.  It does NOT implement JS interop — deployment
 * builds define MOONSHINE_EMBIND_REAL_HEADER and use the real
 * <emscripten/bind.h>, at which point the same shim source compiles
 * unchanged under emcc.
 */
#ifndef MOONSHINE_EMBIND_COMPAT_H
#define MOONSHINE_EMBIND_COMPAT_H

#ifdef MOONSHINE_EMBIND_REAL_HEADER
#include <emscripten/bind.h>
#include <emscripten/val.h>
#else

#include <cstddef>
#include <string>
#include <vector>

namespace emscripten {

/* Opaque JS value stand-in: supports the construction / property-set
 * surface the shim uses. */
class val {
 public:
  val() = default;
  template <typename T>
  explicit val(const T&) {}
  static val object() { return val(); }
  static val array() { return val(); }
  static val null() { return val(); }
  static val undefined() { return val(); }
  template <typename K, typename V>
  void set(const K&, const V&) {}
  template <typename T>
  T as() const { return T(); }
  bool isNull() const { return true; }
  bool isUndefined() const { return true; }
};

template <typename T>
std::vector<T> convertJSArrayToNumberVector(const val&) {
  return {};
}

template <typename T>
class class_ {
 public:
  explicit class_(const char*) {}
  template <typename... Args>
  class_& constructor() { return *this; }
  template <typename F>
  class_& function(const char*, F) { return *this; }
  template <typename F>
  class_& class_function(const char*, F) { return *this; }
  template <typename P>
  class_& property(const char*, P) { return *this; }
};

template <typename F>
void function(const char*, F) {}

template <typename T>
class register_vector {
 public:
  explicit register_vector(const char*) {}
};

}  // namespace emscripten

/* The real macro registers an initializer with the Embind runtime; the
 * compile-surface variant produces an ordinary function so the
 * registration body still type-checks and links. */
#define EMSCRIPTEN_BINDINGS(name) \
  static void moonshine_embind_register_##name(); \
  struct moonshine_embind_invoke_##name { \
    moonshine_embind_invoke_##name() { \
      moonshine_embind_register_##name(); \
    } \
  }; \
  static moonshine_embind_invoke_##name moonshine_embind_instance_##name; \
  static void moonshine_embind_register_##name()

#endif /* MOONSHINE_EMBIND_REAL_HEADER */
#endif /* MOONSHINE_EMBIND_COMPAT_H */
