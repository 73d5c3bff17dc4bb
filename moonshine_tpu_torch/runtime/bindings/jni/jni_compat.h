/* Minimal JNI type/function declarations for compiling the Android shim
 * in an environment with no JDK.
 *
 * Purpose: a COMPILE-SURFACE stand-in.  It declares the JNI types and
 * the handful of JNIEnv functions moonshine_jni.cpp uses with their
 * specified prototypes, so the shim's thin-wrapper claim over
 * moonshine_client.h is checked by an actual compile + link.  It does
 * NOT reproduce the JNIEnv function-table slot layout — deployment
 * builds must use the real <jni.h> (define MOONSHINE_JNI_REAL_HEADER),
 * at which point the same shim source compiles unchanged: the JNI_CALL
 * macro maps to JNIEnv member calls.
 */
#ifndef MOONSHINE_JNI_COMPAT_H
#define MOONSHINE_JNI_COMPAT_H

#ifdef MOONSHINE_JNI_REAL_HEADER
#include <jni.h>
/* Real header: JNIEnv exposes member functions. */
#define JNI_CALL(env, fn, ...) (env)->fn(__VA_ARGS__)
#else

#include <stdint.h>

typedef uint8_t jboolean;
typedef int8_t jbyte;
typedef int16_t jshort;
typedef int32_t jint;
typedef int64_t jlong;
typedef float jfloat;
typedef double jdouble;
typedef jint jsize;

struct _jobject;
typedef struct _jobject* jobject;
typedef jobject jclass;
typedef jobject jstring;
typedef jobject jarray;
typedef jobject jfloatArray;

#define JNIEXPORT __attribute__((visibility("default")))
#define JNICALL
#define JNI_VERSION_1_6 0x00010006
#define JNI_FALSE 0
#define JNI_TRUE 1

/* The subset of the JNIEnv interface the shim uses, declared as a plain
 * function-pointer table (prototypes per the JNI specification). */
struct JNIEnvOps {
  const char* (*GetStringUTFChars)(void* env, jstring s, jboolean* is_copy);
  void (*ReleaseStringUTFChars)(void* env, jstring s, const char* utf);
  jstring (*NewStringUTF)(void* env, const char* utf);
  jsize (*GetArrayLength)(void* env, jarray a);
  jfloatArray (*NewFloatArray)(void* env, jsize n);
  void (*GetFloatArrayRegion)(void* env, jfloatArray a, jsize start, jsize n,
                              jfloat* out);
  void (*SetFloatArrayRegion)(void* env, jfloatArray a, jsize start, jsize n,
                              const jfloat* src);
};
typedef struct JNIEnv_ {
  const struct JNIEnvOps* fns;
} JNIEnv;

#define JNI_CALL(env, fn, ...) ((env)->fns->fn((void*)(env), __VA_ARGS__))

typedef struct JavaVM_ JavaVM;

#endif /* MOONSHINE_JNI_REAL_HEADER */
#endif /* MOONSHINE_JNI_COMPAT_H */
